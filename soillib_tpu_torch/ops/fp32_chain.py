"""The FP32 throughput probe (counterpart of the kernel of
`_vpu_chain_time` in the JAX package's bench.py): K = 4 independent
chains per element, carried across `reps` rounds of U = 16 applications
of one op, summed at the end.

`chain_cuda` launches the hand-written kernel csrc/fp32_chain.cu (one
launch per call, counted in `fp32_chain_launches`); `chain_plain` is the
same chains as a Python loop of torch ops, for the CPU tests and the
bench's `--device cpu`; `chain` picks one by the tensor's device.

Ops (csrc/fp32_chain.cu fixes each one's instructions):
  fma   y * 1.0000001 + 1e-9, one fused multiply-add
  fma2  fma, then y * 0.9999999 + 1e-9: two of them
  exp   exp(-y) + 0.1
  div   1.5 / (y + 1)
  sqrt  sqrt(y + 0.25)
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

K = 4
U = 16
OPS = ("fma", "fma2", "exp", "div", "sqrt")
THREADS = 256

# Kernel launches per op, counted where the wrapper launches the kernel.
fp32_chain_launches = {op: 0 for op in OPS}

_A = float(np.float32(1.0000001))
_A2 = float(np.float32(0.9999999))
_B = float(np.float32(1e-9))


def _fma(y, a):
    """float32 fma(y, a, 1e-9): the exact product (float64 holds it)
    plus b, rounded to float32 (float64 rounds first, so the result can
    differ from a single rounding in a rare last bit)."""
    return (y.double() * a + _B).float()


def _apply(op, y):
    if op == "fma":
        return _fma(y, _A)
    if op == "fma2":
        return _fma(_fma(y, _A), _A2)
    if op == "exp":
        return torch.exp(-y) + 0.1
    if op == "div":
        return torch.full((), 1.5, device=y.device) / (y + 1.0)
    if op == "sqrt":
        return torch.sqrt(y + 0.25)
    raise ValueError(f"unknown op {op!r}; one of {OPS}")


def chain_plain(x, op, reps):
    """The probe's chains in plain torch: (n,) float32 sums."""
    ys = [x * float(np.float32(1.0 + 0.001 * k)) for k in range(K)]
    for _ in range(int(reps)):
        for _ in range(U):
            ys = [_apply(op, y) for y in ys]
    acc = ys[0]
    for y in ys[1:]:
        acc = acc + y
    return acc


def _lib():
    from soillib_tpu_torch import _native

    fn = _native.load("fp32_chain").fp32_chain_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def chain_cuda(x, op, reps, out=None):
    """One launch of the probe kernel on the card over the (n,) float32
    CUDA tensor x; returns `out` (allocated when None)."""
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; one of {OPS}")
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or x.dim() != 1 or not x.is_contiguous():
        raise ValueError("x must be a contiguous 1-D float32 tensor")
    if out is None:
        out = torch.empty_like(x)
    elif out.shape != x.shape or not out.is_contiguous() or out is x:
        raise ValueError("out must be a distinct contiguous tensor like x")
    fn = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(OPS.index(op), x.data_ptr(), out.data_ptr(), x.numel(),
                 int(reps), stream)
    if err != 0:
        raise RuntimeError(f"fp32_chain kernel launch failed: CUDA error "
                           f"{err}")
    fp32_chain_launches[op] += 1
    return out


def chain(x, op, reps):
    """The probe's chains: the kernel on CUDA tensors, plain torch on CPU
    tensors."""
    if x.device.type == "cuda":
        return chain_cuda(x, op, reps)
    if x.device.type != "cpu":
        raise ValueError(f"no probe for device {x.device}")
    return chain_plain(x, op, reps)


def probe_elements(device) -> int:
    """Elements of one probe launch: on the card 8 blocks of THREADS
    threads per SM, so every SM's schedulers have work; on the CPU a
    small block."""
    device = torch.device(device)
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        return sms * 8 * THREADS
    return 8 * 1024


def ops_per_launch(n, reps) -> int:
    """Operations of one launch (one per op application)."""
    return int(n) * K * U * int(reps)
