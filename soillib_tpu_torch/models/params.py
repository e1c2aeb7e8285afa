"""Erosion model parameterization.

Field names, defaults, and units replicate `soil::param_t`
(model/path/erosion.hpp:17-58) and its Python binding
(python/source/model.cpp:23-60). Legacy aliases used by the reference's
older example scripts (erosion_gpu.py:86-100 — e.g. `viscosity`,
`bedShear`, `critSlope`, `debris*`) are accepted via attribute aliasing.

The dataclass is mutable for script convenience ("the script is the
config"), and `.freeze()` produces a hashable snapshot of it;
`ErosionParams.from_frozen` rebuilds parameters from such a snapshot, so a
configuration can cross between the JAX package and this one as plain
(name, value) pairs.

This is a copy of `soillib_tpu/models/params.py`, not an import of it:
importing that module runs `soillib_tpu/__init__.py`, which imports JAX.
"""

from __future__ import annotations

import dataclasses


_ALIASES = {
    # old example name          -> current param_t name
    "viscosity": "viscosityWater",
    "bedShear": "bedShearWater",
    "density": "densityWater",
    "suspensionRate": "suspensionRateFluvial",
    "depositionRate": "depositionRateFluvial",
    "critSlope": "critSlopeBedrock",
    "debrisCreepRate": "landslideRateDebris",
    "debrisSuspensionRate": "suspensionRateDebris",
    "debrisDepositionRate": "depositionRateDebris",
    "debrisYieldStress": "yieldStress",
    "debrisDensity": "densityDebris",
    "debrisViscosity": "viscosityDebris",
    "debrisBedShear": "bedShearDebris",
    "samples": "nSamples",
}


@dataclasses.dataclass
class ErosionParams:
    # Simulation parameters (erosion.hpp:19-22)
    maxage: int = 512          # Maximum particle age / transport rounds
    lrate: float = 1.0         # Filter learning rate []
    timeStep: float = 250.0    # Geological timestep [y]

    # Boundary / environmental conditions (erosion.hpp:24-29)
    exitSlope: float = 0.02    # Boundary slope [m/m]
    uplift: float = 0.001      # Uplift rate [m/y]
    rainfall: float = 1.0      # Rainfall rate [m/y]
    gravity: float = 9.81      # Specific gravity [m/s^2]
    evapRate: float = 0.0002   # Water evaporation rate

    # Erosion parameters (erosion.hpp:31-40)
    frictionFactor: float = 0.06
    fluvialExponent: float = 2.0
    suspensionRateFluvial: float = 4.5e-8
    depositionRateFluvial: float = 0.04
    suspensionRateDebris: float = 0.001
    depositionRateDebris: float = 0.01
    landslideRateDebris: float = 0.003

    # Material properties (erosion.hpp:42-53)
    critSlopeBedrock: float = 0.57
    critSlopeSediment: float = 0.3
    yieldStress: float = 0.001
    viscosityWater: float = 1e-6
    bedShearWater: float = 0.0075
    densityWater: float = 1.0
    viscosityDebris: float = 0.0
    bedShearDebris: float = 0.99
    densityDebris: float = 2.0

    # Arbitrary body force (erosion.hpp:56)
    force: tuple = (0.0, 0.0)

    # Extensions over param_t (not in the reference struct):
    nSamples: int = 8192       # particle count (ref: rng.elem(); old `samples`)
    transportMethod: str = "field"     # "field" | "particles"
    transportIterations: int = 0       # 0 -> maxage-2 (the faithful
    # deposit depth: the MC loop runs maxage-1 rounds and its first
    # never deposits — see transport_fluvial)
    # Convergence-adaptive transport depth (field method only): > 0 makes
    # the round count an UPPER bound — the cohort solve exits once the
    # remaining deposits are provably below this fraction of the
    # accumulated ones (ops/cohort.py carried_live/tail_converged:
    # contractive rules like the fluvial physics use the live-mass x
    # rounds-left bound; debris and arbitrary rules exit only at
    # exact-zero live, sound for any physics). At 1e-6 the result
    # matches the fixed full-depth solve to f32 roundoff while costing
    # only the rounds that still move mass — this is what makes the
    # reference-faithful depth (maxage-2 rounds, erosion.cu:101)
    # affordable on TPU. Forward-only (lax.while_loop); keep 0.0 for
    # differentiable solves.
    transportTol: float = 0.0
    # Albedo instrumentation toggle: albedo never feeds back into the
    # height/water/debris dynamics, so turning it off changes no
    # prognostic field while dropping 3 carried channels from each
    # transport solve and letting all four albedo state fields stay
    # broadcastable constants — the single-chip 8192² capacity mode.
    # Honored by the field/cohort transports and mass_transfer; the
    # particle estimator always tracks.
    trackAlbedo: bool = True
    # Cohort-closure configuration (ops/cohort.py CohortClosure) for the
    # default `method="field"` transports; None -> the process default
    # (the SOIL_COHORT_* env vars). Set it here — not via env — when
    # comparing closure variants in one process: the frozen dataclass is
    # hashable and enters the jit cache key through `.freeze()`, while
    # env toggles do not.
    closure: object = None
    # Debris-transport closure. Default None = `closure` with the
    # mixture-refinement quality knobs (nodes/colors) STRIPPED: the
    # debris cohort parity already sits at the MC floor at the default
    # closure (corr 1.0 / rel 0.0 on every study terrain —
    # benchmarks/quality_r5_8x_sweep.json and the parity_debris net), so
    # a quality run pays nodes*colors only on the fluvial solve (~halves
    # quality-mode step cost at zero measured debris fidelity loss).
    # Pass "same" to apply `closure` verbatim, or an explicit
    # CohortClosure.
    closureDebris: object = None

    def __setattr__(self, name, value):
        name = _ALIASES.get(name, name)
        if name not in _FIELD_NAMES:
            # The reference's nanobind param_t rejects unknown attributes;
            # silently accepting a typo'd parameter would leave the real
            # field (and the jit cache key) untouched.
            raise AttributeError(
                f"ErosionParams has no parameter {name!r} "
                f"(known: {sorted(_FIELD_NAMES)})"
            )
        if name == "force" and not isinstance(value, tuple):
            value = (float(value[0]), float(value[1]))
        object.__setattr__(self, name, value)

    def __getattr__(self, name):
        # Only called when normal lookup fails -> resolve legacy aliases.
        if name in _ALIASES:
            return getattr(self, _ALIASES[name])
        raise AttributeError(name)

    def freeze(self) -> tuple:
        """Hashable snapshot (jit cache key)."""
        vals = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            vals.append((f.name, tuple(v) if isinstance(v, (list, tuple)) else v))
        return tuple(vals)

    @classmethod
    def from_frozen(cls, frozen) -> "ErosionParams":
        """Parameters from a `freeze()` snapshot ((name, value) pairs),
        this package's or the JAX package's."""
        new = cls()
        for name, value in frozen:
            setattr(new, name, value)
        return new

    def replace(self, **kw) -> "ErosionParams":
        new = dataclasses.replace(self)
        for k, v in kw.items():
            setattr(new, k, v)
        return new


_FIELD_NAMES = {f.name for f in dataclasses.fields(ErosionParams)}

# Reference-compatible constructor name (python binding: soil.param_t()).
param_t = ErosionParams
