"""Render configuration.

Replaces the reference's three config tiers (compile-time constants,
hardcoded scene code, and ImGui-mutable push constants —
``src/vk_engine.h:160-171,202-206,338``) with one declarative, hashable
dataclass.  Instances are static jit arguments: changing a field recompiles,
so anything that must vary per frame (camera, frame index) is passed as
device arrays instead.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from typing import Optional


ROUTES = ("auto", "walk", "kernel", "interpret")


@dataclass(frozen=True)
class Routing:
    """Traversal routing -- hermetic, hashable, a static jit key.

    Environment variables are consulted only by :meth:`from_env` (the
    default when a ``RenderConfig`` carries ``routing=None``), so passing
    an explicit ``Routing`` makes trace-time behavior independent of
    process state.
    """

    # Triangle traversal on flattened scenes:
    #   "auto"      the Pallas walk kernel (kernels/walk_gpu.py) on a GPU,
    #               the XLA gather walk everywhere else;
    #   "walk"      the XLA gather walk (ops/traverse._walk), the oracle;
    #   "kernel"    the walk kernel compiled for the GPU;
    #   "interpret" the walk kernel in the Pallas interpreter (CPU tests).
    # Forest (non-flattened) scenes always take the gather walk.
    route: str = "auto"
    # Coherence-binning key widths (integrator): morton bits per origin
    # axis, and extra |direction| bits inside the octant.
    bin_bits: int = 6
    bin_dir_bits: int = 0
    # Bounce-round coherence key flavor (binned wavefront only):
    #   "morton"  (octant, bin_bits-morton of origin);
    #   "leaf"    (octant, previous-hit primitive id): prim ids follow the
    #             SBVH builder's DFS order, an adaptive space-filling curve
    #             over the geometry; regenerated camera rays key by pixel
    #             id, dead lanes to the end;
    #   "hier"    (octant, morton) primary + prev-hit prim id sub-order
    #             (two stable argsorts).
    # Images are bit-identical in every mode (binning is a permutation).
    bin_mode: str = "morton"
    # Shadow-query placement relative to the round's binning permute
    # (anyhit NEE, binned wavefront only):
    #   "off"    NEE columns ride the main permute; the shadow query runs
    #            after it, in the bounce key's order;
    #   "sort"   shadow rays get their own (active-first, shadow-octant,
    #            origin cell) argsort before the query;
    #   "nosort" the shadow query runs before the permute, in main-wave
    #            order; only a slim state permute remains.
    # Images are bit-identical across modes (per-lane results are
    # permutation-invariant; every resolve op is elementwise).
    nee_prebin: str = "off"

    def __post_init__(self):
        if self.route not in ROUTES:
            raise ValueError(
                f"Routing.route must be one of {ROUTES}, got {self.route!r}"
            )

    @staticmethod
    def from_env() -> "Routing":
        """Default routing with ``RT_*`` env overrides (tools/CLI)."""
        return Routing(
            route=os.environ.get("RT_ROUTE", "auto"),
            bin_bits=int(os.environ.get("RT_BIN_BITS", 6)),
            bin_dir_bits=int(os.environ.get("RT_BIN_DIR_BITS", 0)),
            bin_mode=os.environ.get("RT_BIN_MODE", "morton"),
            nee_prebin=os.environ.get("RT_NEE_PREBIN", "off"),
        )

    def replace(self, **kw) -> "Routing":
        return replace(self, **kw)


@dataclass(frozen=True)
class RenderConfig:
    width: int = 512
    height: int = 512
    # Samples traced per pixel per call (reference raysPerPixel /
    # sampleLimit, vk_engine.h:164,170).
    samples_per_pixel: int = 1
    # Bounce loop runs bounce_limit + 1 times (``j <= bounceLimit``,
    # raytrace.comp:495).
    bounce_limit: int = 8
    seed: int = 0
    # Russian roulette: probability 1 while ``j <= rr_start_bounce``
    # (raytrace.comp:522), survival clamped at rr_clamp (:521).
    rr_start_bounce: int = 5
    rr_clamp: float = 0.95
    # Capability extension (reference quirk Q1: its snapshot never samples
    # textures); disable for strict same-seed comparisons vs the snapshot.
    enable_textures: bool = True
    # Pixel-center jitter for anti-aliasing. The reference samples each pixel
    # at its corner every time (raytrace.comp:541) — keep False for parity.
    aa_jitter: bool = False
    # Capability extension CLOSING reference quirk Q8: the reference
    # parses map_bump and carries tangent/binormal fields, but
    # calculate_binormal never writes its outputs (vk_engine.cpp:
    # 1040-1058) — bump mapping is dead there.  True enables WORKING
    # height-map bump mapping: tangent frame solved from triangle edges
    # + UV deltas (exactly what calculate_binormal intended), 3-tap
    # height gradient, normal perturbed by bump_scale.  Default False =
    # snapshot-exact shading.  Flattened scenes only (the production
    # path); forest-compat scenes ignore it.
    enable_normal_maps: bool = False
    # Perturbation strength in per-texel height-gradient units (the
    # gradient of a [0,1] height map across one texel, so the look is
    # resolution-stable).
    bump_scale: float = 1.0
    # Pixels per dispatch: render() tiles the image into chunks of this
    # many pixels, each traced as one program, to bound the live wavefront
    # state (tens of float32 columns per lane) in device memory.
    max_rays_per_batch: int = 1 << 17
    # Samples per dispatch within a tile: big-spp renders are split into
    # per-chunk dispatches so one program's run time stays bounded;
    # results are identical (counter-based RNG + exact chunk-weighted
    # mean).
    max_spp_per_dispatch: int = 32
    # Lane-pool ceiling for the spp-lane population mode (wavefront
    # trace_wave): each pixel's samples are split across up to
    # lane_pool // n_pixels lanes, so one wavefront holds more
    # independent paths.  0 = auto (1 << 23); 1 disables expansion
    # (lanes = pixels).
    lane_pool: int = 0
    # Multi-phase drain divisor (binned trace_wave): the live wavefront
    # array shrinks by this factor whenever the alive count falls below
    # the next width, bounding within-phase occupancy waste.  0 = auto
    # (4); 2 halves the waste bound at the cost of more bank/slice steps.
    drain_div: int = 0
    # Compact bounce/NEE rays alive-first before traversal (static-scan
    # integrator, closest-hit NEE only): a stable two-bucket partition
    # (one cumsum + one scatter + gathers).  None (auto) = off; per-lane
    # results are identical either way.
    sort_bounce_rays: "bool | None" = None
    # NEE shadow rays as true ANY-HIT occlusion queries (lanes stop at
    # their first hit) with the light pdf computed analytically at the
    # sampled distance — the value the reference's closest-hit raycast
    # returns when unoccluded (raytrace.comp:396-402).  Deviation: an
    # emissive surface strictly between the shading point and the light
    # occludes instead of contributing its own emission (impossible in
    # scenes whose only emitters are the lights, i.e. all presets and
    # reference scenes).  False restores the closest-hit resolve.
    nee_anyhit: bool = True
    # Path regeneration: render all samples of a tile in one while_loop
    # where a lane whose path terminates immediately starts its pixel's
    # next sample, instead of a static (bounce_limit+1) x spp scan whose
    # occupancy decays with bounce depth.
    # Radiometrically identical (same counter-based RNG streams).  False
    # restores the static scan (the reference-shaped schedule).
    path_regen: bool = True
    # Ray binning (path_regen only): each wavefront round sorts lanes by
    # (direction octant, morton cell of origin) before traversal, so
    # neighbouring lanes share direction signs and an origin cell, and
    # dead lanes gather at the tail (which enables the multi-phase drain).
    # The whole per-lane state rides one packed row-gather; per-lane
    # results are permutation-invariant (counter-based RNG keyed on
    # pixel/sample/bounce), so images are bit-identical to
    # bin_rays=False.  None (auto) = off.
    bin_rays: "bool | None" = None
    # Capability extension: multiply specular/dielectric bounce radiance by
    # the material albedo (gold metal, colored glass).  The reference
    # SNAPSHOT's BTDFs return untinted vec3(1) (raytrace.comp:467,479), but
    # its gallery screenshots (dragon_gold, monkey_dielectric blue glass,
    # dread_metallic) were clearly produced by an earlier tinting shader —
    # like quirk Q1's dead texture path.  Default False = snapshot-exact.
    tint_spec_diel: bool = False
    # Estimator ablation, reproducing the reference's importance-sampling
    # study (renders/importance_sampling/): "mis" = production NEE + MIS
    # (the 0/1-NEE pattern, raytrace.comp:430-464); "cosine" = cosine-
    # weighted hemisphere sampling only, no NEE (cornell_cosine.png);
    # "uniform" = uniform hemisphere sampling, no NEE (cornell_uniform.png).
    # Non-default modes route through the static-scan integrator.
    estimator: str = "mis"
    # Traversal routing.  None = resolve from RT_* env vars at trace time
    # (interactive/tools default); an explicit Routing is hermetic.
    routing: Optional[Routing] = None

    def resolved_routing(self) -> Routing:
        return self.routing if self.routing is not None else Routing.from_env()

    def replace(self, **kw) -> "RenderConfig":
        return replace(self, **kw)

    @property
    def n_pixels(self) -> int:
        return self.width * self.height
