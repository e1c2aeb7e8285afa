"""The port's host utilities on the CPU: `yield_t` / `make_yield` /
`prefetch` against the JAX package's behaviour (the eleven cases of
tests/test_yieldgen.py, each run through both packages), the step
checkpoints, `silt` against the JAX package's, and the native library
(`soillib_tpu_torch.native`) against the port's Python and numpy paths.

Three cases hold the port where it deliberately differs from the JAX
package (its faults): `move()` takes a peeked value along, a type
mismatch poisons the handle instead of skipping the item (and a tuple
`value_type` works), and `prefetch(depth=d)` has d transfers in flight.

The native cases skip only where there is no g++; where there is one,
the library must build.
"""

import dataclasses
import importlib
import shutil
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import soillib_tpu as jsoil
import soillib_tpu_torch as soil
from soillib_tpu import silt as jsilt
from soillib_tpu_torch import native, silt
from soillib_tpu_torch.io import tiffcore
from soillib_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
from soillib_tpu_torch.testing import lzw_encode

pmesh = importlib.import_module("soillib_tpu_torch.io.mesh")
torch.set_num_threads(1)

PACKAGES = [pytest.param(jsoil, id="jax"), pytest.param(soil, id="port")]


def _gen(n):
    for i in range(n):
        yield i


# ---------------------------------------------------------------------------
# yield_t / make_yield / prefetch: tests/test_yieldgen.py, both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_bool_peek_then_call_take(pkg):
    y = pkg.yield_t(_gen(3))
    out = []
    while y:
        out.append(y())
    assert out == [0, 1, 2]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_bool_is_idempotent_peek(pkg):
    y = pkg.yield_t(_gen(1))
    assert bool(y) and bool(y) and bool(y)
    assert y() == 0
    assert not y


@pytest.mark.parametrize("pkg", PACKAGES)
def test_iterator_adapter_and_tuple_unpack(pkg):
    def pairs():
        for i in range(3):
            yield pkg.make_yield(i, float(i) * 2.0)

    got = [(i, v) for i, v in pkg.yield_t(pairs())]
    assert got == [(0, 0.0), (1, 2.0), (2, 4.0)]
    assert pkg.make_yield(7) == 7


@pytest.mark.parametrize("pkg", PACKAGES)
def test_exception_propagates_at_retrieve_site(pkg):
    def boom():
        yield 1
        raise ValueError("inside coroutine")

    y = pkg.yield_t(boom())
    assert y() == 1
    with pytest.raises(ValueError, match="inside coroutine"):
        bool(y)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_strict_typing(pkg):
    y = pkg.yield_t(iter([1, "two"]), value_type=int)
    assert y() == 1
    with pytest.raises(TypeError, match="strict-typed"):
        y()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_single_pass_reiteration_raises(pkg):
    y = pkg.yield_t(_gen(2))
    assert list(y) == [0, 1]
    assert not y
    with pytest.raises(RuntimeError, match="single-pass"):
        iter(y).__next__()


@pytest.mark.parametrize("pkg", PACKAGES)
def test_move_semantics_invalidate_source(pkg):
    y = pkg.yield_t(_gen(3))
    assert y() == 0
    z = y.move()
    with pytest.raises(RuntimeError, match="moved or destroyed"):
        bool(y)
    assert list(z) == [1, 2]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_exhausted_call_raises_stopiteration(pkg):
    y = pkg.yield_t(_gen(0))
    assert not y
    with pytest.raises(StopIteration):
        y()


def _values(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def test_prefetch_order_and_device_transfer():
    items = [np.full((4, 4), i, np.float32) for i in range(5)]
    want = list(jsoil.prefetch(iter(items), depth=2))
    got = list(soil.prefetch(iter(items), depth=2, device="cpu"))
    assert len(got) == len(want) == 5
    for i, (a, b) in enumerate(zip(got, want)):
        assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
        assert isinstance(b, jax.Array)
        np.testing.assert_array_equal(_values(a), items[i])
        np.testing.assert_array_equal(_values(a), _values(b))


def test_prefetch_nested_structures_and_passthrough():
    def tiles():
        for i in range(3):
            yield (f"tile{i}", np.full((2, 2), i, np.float32))

    want = list(jsoil.prefetch(tiles(), depth=3))
    got = list(soil.prefetch(tiles(), depth=3, device="cpu"))
    assert [n for n, _ in got] == [n for n, _ in want] == \
        ["tile0", "tile1", "tile2"]
    for i, ((_, a), (_, b)) in enumerate(zip(got, want)):
        assert isinstance(a, torch.Tensor)
        assert float(a[0, 0]) == float(jnp.asarray(b)[0, 0]) == float(i)


def test_prefetch_depth_validation_and_short_streams():
    for pkg, kw in ((jsoil, {}), (soil, {"device": "cpu"})):
        with pytest.raises(ValueError):
            list(pkg.prefetch([1], depth=0, **kw))
        assert list(pkg.prefetch([], depth=4, **kw)) == []
        assert [int(x) for x in pkg.prefetch([np.int32(7)], depth=4,
                                             **kw)] == [7]


def test_prefetch_put_overrides_the_transfer():
    got = list(soil.prefetch(iter([1, 2, 3]), depth=1,
                             put=lambda x: ("put", x)))
    assert got == [("put", 1), ("put", 2), ("put", 3)]


# --- where the port deliberately differs (the JAX package's faults) ------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_move_takes_a_peeked_value_along(pkg):
    """Peek, then move: the new handle yields the peeked item; the old one
    is empty. The JAX package's old handle still answers True and hands
    out the same item again."""
    y = pkg.yield_t(_gen(3))
    assert bool(y)
    z = y.move()
    if pkg is jsoil:
        assert bool(y) and y() == 0 and list(z) == [0, 1, 2]
        return
    with pytest.raises(RuntimeError, match="moved or destroyed"):
        bool(y)
    with pytest.raises(RuntimeError, match="moved or destroyed"):
        y()
    assert list(z) == [0, 1, 2]


@pytest.mark.parametrize("pkg", PACKAGES)
def test_type_mismatch_is_not_skipped_silently(pkg):
    """A mismatched value: the JAX package drops it and goes on with the
    next; the port raises the TypeError again at every later use. A tuple
    value_type is accepted (the JAX package's message fails on it)."""
    y = pkg.yield_t(iter([1, "two", 3]), value_type=int)
    assert y() == 1
    with pytest.raises(TypeError, match="strict-typed"):
        y()
    if pkg is jsoil:
        assert y() == 3
        t = pkg.yield_t(iter([1.5, b"x"]), value_type=(int, float))
        assert t() == 1.5
        with pytest.raises(AttributeError):
            t()
        return
    for _ in range(2):
        with pytest.raises(TypeError, match="strict-typed"):
            bool(y)
    t = pkg.yield_t(iter([1.5, 2, b"x"]), value_type=(int, float))
    assert t() == 1.5 and t() == 2
    with pytest.raises(TypeError, match="int or float.*bytes"):
        t()


@pytest.mark.parametrize("pkg,depth", [(jsoil, 1), (jsoil, 3), (soil, 1),
                                       (soil, 3)])
def test_prefetch_has_depth_items_in_flight(pkg, depth):
    """When item i is handed out, the port has put items i+1 .. i+depth
    already (the JAX package i+1 .. i+depth-1)."""
    pulled = []

    def source():
        for i in range(8):
            pulled.append(i)
            yield np.full((2,), i, np.float32)

    kw = {"device": "cpu"} if pkg is soil else {}
    ahead = [len(pulled) - 1 - i
             for i, _ in enumerate(pkg.prefetch(source(), depth, **kw))]
    want = depth if pkg is soil else depth - 1
    assert ahead[:8 - depth] == [want] * (8 - depth)


# ---------------------------------------------------------------------------
# Step checkpoints
# ---------------------------------------------------------------------------


def _state(seed=0, shape=(12, 10)):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.random(shape).astype(np.float32))
    return soil.ErosionState.zeros(shape, height=h, rainfall=1.5,
                                   albedo_surface=(0.2, 0.3, 0.4),
                                   device="cpu")


def _equal_states(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.shape == y.shape and x.dtype == y.dtype, f.name
        assert torch.equal(x.view(torch.int32), y.view(torch.int32)), f.name


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    st = _state()
    path = save_checkpoint(str(tmp_path / "ck"), st, 3)
    assert path == str((tmp_path / "ck" / "step_3").resolve())
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["step_3"]
    back = load_checkpoint(str(tmp_path / "ck"), _state(1), 3)
    assert isinstance(back, soil.ErosionState)
    assert back.rainfall.shape == (1, 1)   # compact fields stay compact
    _equal_states(back, st)
    # Saving the same step again replaces the file.
    save_checkpoint(str(tmp_path / "ck"), _state(2), 3)
    _equal_states(load_checkpoint(str(tmp_path / "ck"), st, 3), _state(2))


def test_checkpoint_resume_continues_bitwise(tmp_path):
    """Two steps in one go equal one step, a checkpoint, a load and one
    more step."""
    p = soil.ErosionParams()
    p.transportIterations = 4
    scale = (0.1, 0.1, 4.0)
    want = soil.erode(_state(3), scale, p, steps=2)
    mid = soil.erode(_state(3), scale, p)
    save_checkpoint(str(tmp_path), mid, 1)
    got = soil.erode(load_checkpoint(str(tmp_path), mid, 1), scale, p)
    _equal_states(got, want)


def test_checkpoint_nested_trees_and_mismatches(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": (torch.ones(2, dtype=torch.int64), [torch.zeros(1), 7])}
    save_checkpoint(str(tmp_path), tree, 0)
    back = load_checkpoint(str(tmp_path), tree, 0, device="cpu")
    assert isinstance(back["b"], tuple) and isinstance(back["b"][1], list)
    assert torch.equal(back["a"], tree["a"]) and back["b"][1][1] == 7
    assert torch.equal(back["b"][0], tree["b"][0])
    with pytest.raises(ValueError, match="expected"):
        load_checkpoint(str(tmp_path), {**tree, "a": torch.zeros(3, 2)}, 0)
    with pytest.raises(ValueError, match="other keys"):
        load_checkpoint(str(tmp_path), {"a": tree["a"]}, 0)
    with pytest.raises(FileNotFoundError):
        load_checkpoint(str(tmp_path), tree, 1)


# ---------------------------------------------------------------------------
# silt
# ---------------------------------------------------------------------------


def test_silt_tensor_surface_matches_jax():
    for mod, host in ((jsilt, jsilt.cpu), (silt, silt.cpu)):
        t = mod.tensor(mod.float32, mod.shape(6, 4), host)
        assert t.elem() == 24 and tuple(t.shape.dims) == (6, 4)
        assert t.numpy().dtype == np.float32 and not t.numpy().any()
    t = silt.tensor(silt.float32, silt.shape(6, 4), silt.cpu)
    assert t.array.device.type == "cpu" and t.cpu().array.device.type == \
        "cpu"
    assert repr(t) == "silt.tensor(6, 4)[torch.float32]"
    with pytest.raises(ValueError):
        silt.tensor(silt.float32)
    i = silt.tensor(silt.int32, silt.shape(3), silt.cpu)
    assert i.numpy().dtype == np.int32


def test_silt_functional_ops_match_jax():
    rng = np.random.default_rng(9)
    a = rng.normal(size=(5, 7)).astype(np.float32)
    tj, tp = jsilt.tensor.from_numpy(a), silt.tensor.from_numpy(a)
    ops = [
        lambda m, t: m.set(t, 2.5),
        lambda m, t: m.multiply(t, 3.0),
        lambda m, t: m.add(t, -1.25),
        lambda m, t: m.clamp(t, -0.5, 0.5),
        lambda m, t: m.clone(t),
        lambda m, t: m.clamp(m.add(m.multiply(t, 2.0), 0.5), 0.0, 1.0),
    ]
    for k, op in enumerate(ops):
        want, got = op(jsilt, tj), op(silt, tp)
        assert isinstance(got, silt.tensor), k
        np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=k)
    # The ops are functional: the input is unchanged.
    np.testing.assert_array_equal(tp.numpy(), a)
    # On bare tensors they return tensors.
    assert torch.equal(silt.add(torch.ones(2), 1.0), torch.full((2,), 2.0))


def test_silt_seed_and_reexports():
    t = silt.tensor(silt.float32, silt.shape(4), silt.cpu)
    g1, g2 = silt.seed(t, 5, 1), silt.seed(t, 5, 1)
    assert isinstance(g1, torch.Generator) and g1.device.type == "cpu"
    assert torch.equal(torch.rand(8, generator=g1),
                       torch.rand(8, generator=g2))
    assert not torch.equal(torch.rand(8, generator=silt.seed(t, 5, 2)),
                           torch.rand(8, generator=silt.seed(t, 5, 1)))
    r = silt.tensor(silt.rng, silt.shape(4, 4), silt.cpu)
    assert isinstance(r.array, torch.Generator) and r.elem() == 16
    assert silt.seed(r, 5, 1).device.type == "cpu"
    assert silt.shape is soil.Shape
    assert silt.copy is soil.copy and silt.resize is soil.resize


# ---------------------------------------------------------------------------
# The native library
# ---------------------------------------------------------------------------


@pytest.fixture
def lib():
    """The native library; skips only without g++."""
    if shutil.which("g++") is None:
        pytest.skip("no g++: the native library cannot be built here")
    assert native.available(), native.build_error()
    return native


def _packbits_encode(raw: bytes) -> bytes:
    enc = bytearray()
    i = 0
    while i < len(raw):
        run = 1
        while i + run < len(raw) and raw[i + run] == raw[i] and run < 127:
            run += 1
        if run >= 2:
            enc += bytes([257 - run, raw[i]])
            i += run
        else:
            j = i
            while j < len(raw) and (j + 1 >= len(raw)
                                    or raw[j + 1] != raw[j]) and j - i < 127:
                j += 1
            enc += bytes([j - i - 1]) + raw[i:j]
            i = j
    return bytes(enc)


@pytest.mark.parametrize("seed", [0, 1])
def test_native_lzw_matches_the_python_decoder(lib, seed, monkeypatch):
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 9, size=20000, dtype=np.uint8).tobytes()
    raw += b"\x00" * 5000 + raw[:3000]
    enc = lzw_encode(raw)
    assert tiffcore._unpack_lzw(enc) == raw
    assert lib.lzw_decode(enc, len(raw)) == raw
    # The codec's LZW strips take the native path first.
    calls = []
    monkeypatch.setattr(tiffcore, "_unpack_lzw", lambda d: calls.append(d))
    assert tiffcore._decompress(enc, 5, len(raw)) == raw and calls == []
    # A corrupt stream (a code beyond the next table slot) is left to the
    # Python decoder, which names the fault.
    bits = "".join(format(c, "09b") for c in (256, 65, 400, 257))
    bits += "0" * (-len(bits) % 8)
    bad = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    assert lib.lzw_decode(bad, 16) is None
    monkeypatch.undo()
    with pytest.raises(ValueError):
        tiffcore._decompress(bad, 5, 16)


def test_native_packbits_matches_the_python_decoder(lib):
    raw = b"\x01" * 200 + bytes(range(64)) + b"\xff" * 300
    enc = _packbits_encode(raw)
    assert tiffcore._unpack_packbits(enc, len(raw)) == raw
    assert lib.packbits_decode(enc, len(raw)) == raw
    assert tiffcore._decompress(enc, 32773, len(raw)) == raw


def test_native_triangulate_matches_numpy(lib, monkeypatch):
    rng = np.random.default_rng(3)
    h = rng.normal(size=(20, 24)).astype(np.float32)
    h[3, 4] = np.nan
    h[10:12, 7] = np.nan
    got = soil.mesh(torch.from_numpy(h), (0.5, 0.5, 2.0))
    monkeypatch.setattr(pmesh, "_native_triangulate", lambda h, s: None)
    want = soil.mesh(torch.from_numpy(h), (0.5, 0.5, 2.0))
    np.testing.assert_allclose(got.vertices, want.vertices, rtol=1e-6)
    assert len(got.faces) == len(want.faces)
    # The same triangles: native interleaves a quad's two like the
    # reference io/mesh.hpp, numpy batches them.
    assert {tuple(t) for t in got.faces.tolist()} == \
        {tuple(t) for t in want.faces.tolist()}


def test_native_binary_ply_is_the_numpy_writers_bytes(lib, tmp_path,
                                                      monkeypatch):
    h = np.linspace(0, 1, 12 * 10, dtype=np.float32).reshape(12, 10)
    m = soil.mesh(h)
    a, b = tmp_path / "native.ply", tmp_path / "numpy.ply"
    assert m.write_binary(str(a))
    monkeypatch.setattr(pmesh, "_native_ply", lambda *args: False)
    assert m.write_binary(str(b))
    assert a.read_bytes() == b.read_bytes()
    header, body = a.read_bytes().split(b"end_header\n", 1)
    assert b"element vertex 120" in header and b"element face 198" in header
    assert len(body) == 120 * 12 + 198 * 13
    assert struct.unpack_from("<B3i", body, 120 * 12)[0] == 3


def test_native_fbm_matches_the_noise(lib):
    """The same lattice hash and gradients as `noise`; float rounding may
    flip the simplex corner on a few cells, so the match is statistical
    (tests/test_native.py's bars)."""
    p = soil.noise_t(octaves=4, ext=(64.0, 64.0), compat=False)
    want = soil.noise((48, 40), p, device="cpu").numpy()
    got = lib.fbm2((48, 40), p.ext, p.frequency, p.octaves, p.gain,
                   p.lacunarity, p.seed)
    close = np.abs(got - want) < 1e-4
    assert close.mean() > 0.98, f"only {close.mean():.3f} of cells match"
    assert np.corrcoef(got.ravel(), want.ravel())[0, 1] > 0.999
