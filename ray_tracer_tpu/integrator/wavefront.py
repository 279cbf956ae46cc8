"""Wavefront path-tracing integrator.

Re-architecture of the reference megakernel's ``trace`` loop
(``shaders/raytrace.comp:483-537``): instead of one divergent per-thread
program, each bounce is a dense batched stage over the whole ray wavefront —
traverse -> gather hit attributes -> evaluate all three BSDF lobes
branchlessly -> NEE -> select -> russian roulette — driven by ``lax.scan``
over a static bounce count with per-lane ``alive`` masks.

Radiometric semantics replicate the reference exactly, including its quirks
(required for image parity at 1024 spp):

* 0/1-NEE accounting: after a diffuse bounce, light arrives only via the
  *pending* ``directLight`` added at the NEXT bounce, scaled by the
  attenuation that already includes this bounce's radiance
  (raytrace.comp:500-517); emission is added directly only at j==0 or after
  specular/dielectric bounces (``directLight.x == -1`` sentinel).
* A pending NEE contribution is dropped when the bounce ray escapes to the
  environment or russian roulette kills the path (the ``break``s at
  raytrace.comp:523,533).
* NaN or negative accumulated color zeroes the whole sample
  (raytrace.comp:505).
* The reference's ``misWeight`` divide on emission (raytrace.comp:501) and
  the ``lightSamplePDF(cosineSample)`` raycast (:453) are *provably inert*:
  emission survives the ``directLight.x == -1`` select only after
  specular/dielectric bounces, whose ``cosineMisWeight`` is always 1.  We
  skip both (one traversal per diffuse bounce saved, identical output).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import RenderConfig
from ..ops import env as env_ops
from ..ops import intersect, traverse
from ..ops.intersect import dot
from ..sampling import bsdf, lights, rng
from ..scene.types import CompiledScene

INV_PI = bsdf.INV_PI


class CameraRays(NamedTuple):
    origin: jnp.ndarray  # (N,3)
    direction: jnp.ndarray  # (N,3)


def raygen(cam_rotation, cam_pos, fov, aspect, near, pixel_id, width, height,
           jitter=None):
    """Primary rays, replicating raytrace.comp:539-560.

    ``uv = pixel / dim`` with no half-pixel offset (reference quirk); the
    view-plane sits at the hardcoded z=0.1 (:550) while its *size* uses
    ``nearPlane`` — both reproduced.
    """
    x = (pixel_id % width).astype(jnp.float32)
    y = (pixel_id // width).astype(jnp.float32)
    if jitter is not None:
        x = x + jitter[:, 0]
        y = y + jitter[:, 1]
    u = x / width
    v = y / height
    plane_h = near * jnp.tan(jnp.radians(fov * 0.5)) * 2.0
    plane_w = plane_h * aspect
    px = -plane_w / 2.0 + plane_w * u
    py = -plane_h / 2.0 + plane_h * v
    point = jnp.stack([px, py, jnp.full_like(px, 0.1)], axis=-1)
    d = point / jnp.linalg.norm(point, axis=-1, keepdims=True)
    # full float32: a GPU may otherwise run this product in TF32, which
    # moves primary rays by up to ~1e-3 relative
    d = jnp.matmul(d, cam_rotation.T, precision=jax.lax.Precision.HIGHEST)
    origin = jnp.broadcast_to(cam_pos, d.shape)
    return CameraRays(origin, d)


def _shade_fetch(scene: CompiledScene, rays: CameraRays, hit: traverse.Hit,
                 cfg: "RenderConfig | None" = None):
    """All deferred shading attributes from ONE fat-row gather.

    Returns ``(hp, normal, uv, albedo, emission, reflectance, ior, tex_id,
    sampler, metal_tex, alpha_tex, front)``.  Everything (vertex attrs AND
    material/instance params) comes from one precompiled 48-float row per
    triangle (``CompiledScene.shade_tri``), one gather per lane instead of
    one per table.

    Triangle barycentrics + facing are RE-DERIVED here from the row's
    geometry fields (v0/e1/e2/n at 32:44) instead of read from ``hit``:
    the walk kernel tracks only (dst, prim), and re-evaluating
    Moller-Trumbore on the same record values reproduces what an in-kernel
    tracker would have stored, without a second (N,16) triangle-row
    gather.  Sphere lanes keep the facing bit the sphere intersector
    reported in ``hit.front``.

    Sphere normals per raytrace.comp:220 (small-table gathers, only when
    the scene has spheres); triangle normals are the barycentric
    vertex-normal lerp (quirk Q7: always smooth, :257-259), face-sign
    flipped then pushed through the object matrix and normalized (:259,318
    — note the reference uses M, not inverse-transpose; replicated).
    No-hit lanes return finite junk; every consumer masks by ``did_hit``.
    """
    hp = rays.origin + rays.direction * hit.dst[:, None]
    is_tri = hit.kind == traverse.KIND_TRI
    tri_i = jnp.where(is_tri, hit.prim, 0)
    srow = scene.shade_tri[tri_i]  # (N,48): the ONE hot gather

    if scene.meta.get("flattened", False):
        # Moller-Trumbore re-evaluation (the formulas of
        # intersect.intersect_tris, plus a zero-direction epsilon).  Valid
        # only on the flattened path, where the row's geometry and the
        # rays share world space; forest mode intersects in OBJECT space,
        # so its walk-produced u/v/front are used as-is (the walk kernel
        # never runs on forest scenes).
        d_eps = jnp.where(rays.direction == 0.0, 1e-20, rays.direction)
        r3 = rays.origin - srow[:, 32:35]
        q3 = jnp.cross(r3, d_eps)
        d0 = -jnp.sum(d_eps * srow[:, 41:44], axis=1)
        dinv = 1.0 / jnp.where(d0 == 0.0, 1e-20, d0)
        hu = jnp.where(
            is_tri, jnp.sum(srow[:, 38:41] * q3, axis=1) * dinv, 0.0
        )
        hv = jnp.where(
            is_tri, -jnp.sum(srow[:, 35:38] * q3, axis=1) * dinv, 0.0
        )
        front = jnp.where(is_tri, d0 >= 1e-8, hit.front)
    else:
        hu, hv, front = hit.u, hit.v, hit.front

    w = 1.0 - hu - hv
    vn0, vn1, vn2 = srow[:, 0:3], srow[:, 3:6], srow[:, 6:9]
    n_obj = vn0 * w[:, None] + vn1 * hu[:, None] + vn2 * hv[:, None]
    n_obj = n_obj * jnp.where(front, 1.0, -1.0)[:, None]
    if scene.meta.get("flattened", False):
        # Geometry (and vertex normals) were baked to world space; the
        # per-hit obj_transform gather + matmul would multiply by identity.
        n_world = n_obj
    else:
        m = scene.obj_transform[jnp.where(is_tri, hit.obj, 0)]
        n_world = jnp.einsum("nij,nj->ni", m[:, :3, :3], n_obj,
                             precision=jax.lax.Precision.HIGHEST)
    normal = n_world / jnp.maximum(
        jnp.linalg.norm(n_world, axis=-1, keepdims=True), 1e-20
    )

    uv0, uv1, uv2 = srow[:, 9:11], srow[:, 11:13], srow[:, 13:15]
    uv = uv0 * w[:, None] + uv1 * hu[:, None] + uv2 * hv[:, None]
    uv = jnp.where(srow[:, 15:16] > 0.5, 0.5, uv)  # raytrace.comp:254-256

    if (
        cfg is not None
        and cfg.enable_normal_maps
        and cfg.enable_textures
        and scene.meta.get("flattened", False)
        and scene.meta.get("n_bump_maps", 0) > 0
        and scene.meta.get("n_textures", 0) > 0
    ):
        # Working height-map bump mapping — the capability the reference
        # plumbs but never finishes (quirk Q8: map_bump parsed at
        # vk_engine.cpp:1127-1141, but calculate_binormal writes nothing,
        # :1040-1058, so Triangle.tangent/binormal stay uninitialized).
        # Tangent frame solved from the row's edges + UV deltas (the
        # textbook system calculate_binormal intended):
        #   [E1; E2] = [T B] . [[du1, dv1], [du2, dv2]]^T
        bump_tex = srow[:, 31].astype(jnp.int32)
        e1, e2 = srow[:, 35:38], srow[:, 38:41]
        duv1 = uv1 - uv0
        duv2 = uv2 - uv0
        det = duv1[:, 0] * duv2[:, 1] - duv2[:, 0] * duv1[:, 1]
        ok_det = jnp.abs(det) > 1e-12
        inv = 1.0 / jnp.where(ok_det, det, 1.0)
        t_vec = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * inv[:, None]
        b_vec = (e2 * duv1[:, 0:1] - e1 * duv2[:, 0:1]) * inv[:, None]
        # Gram-Schmidt against the (smooth, face-flipped) shading normal
        # so the perturbation stays in the local tangent plane.
        t_vec = t_vec - normal * jnp.sum(t_vec * normal, 1, keepdims=True)
        t_hat = t_vec / jnp.maximum(
            jnp.linalg.norm(t_vec, axis=-1, keepdims=True), 1e-20
        )
        b_vec = (
            b_vec
            - normal * jnp.sum(b_vec * normal, 1, keepdims=True)
            - t_hat * jnp.sum(b_vec * t_hat, 1, keepdims=True)
        )
        b_hat = b_vec / jnp.maximum(
            jnp.linalg.norm(b_vec, axis=-1, keepdims=True), 1e-20
        )
        # per-texel height gradient (3 taps); red channel of the map
        tid_b = jnp.maximum(bump_tex, 0)
        hw_b = scene.tex_size[tid_b].astype(jnp.float32)  # (N,2) = (h,w)
        step_u = 1.0 / jnp.maximum(hw_b[:, 1], 2.0)
        step_v = 1.0 / jnp.maximum(hw_b[:, 0], 2.0)
        zeros = jnp.zeros_like(step_u)
        smp_b = srow[:, 25].astype(jnp.int32)  # instance sampler (col 25)
        h0 = _sample_texture(scene, bump_tex, uv, smp_b)[:, 0]
        h_u = _sample_texture(
            scene, bump_tex, uv + jnp.stack([step_u, zeros], 1), smp_b
        )[:, 0]
        h_v = _sample_texture(
            scene, bump_tex, uv + jnp.stack([zeros, step_v], 1), smp_b
        )[:, 0]
        pert = normal - cfg.bump_scale * (
            (h_u - h0)[:, None] * t_hat + (h_v - h0)[:, None] * b_hat
        )
        pert = pert / jnp.maximum(
            jnp.linalg.norm(pert, axis=-1, keepdims=True), 1e-20
        )
        use = is_tri & (bump_tex >= 0) & ok_det
        normal = jnp.where(use[:, None], pert, normal)

    if scene.meta.get("flattened", False):
        albedo = srow[:, 16:19]
        emission = srow[:, 19:22]
        reflectance = srow[:, 22]
        ior = srow[:, 23]
        tex_id = srow[:, 24].astype(jnp.int32)
        sampler = srow[:, 25].astype(jnp.int32)
        metal_tex = srow[:, 29].astype(jnp.int32)
        alpha_tex = srow[:, 30].astype(jnp.int32)
    else:
        # Forest mode (quirk Q11 compat path): instances SHARE triangles,
        # so material/sampler belong to the instance, not the row.
        obj_i = jnp.where(is_tri, hit.obj, 0)
        mat = scene.obj_mat[obj_i]
        albedo = scene.mat_albedo[mat]
        emission = (
            scene.mat_emission[mat]
            * scene.mat_emission_strength[mat][:, None]
        )
        reflectance = scene.mat_reflectance[mat]
        ior = scene.mat_ior[mat]
        tex_id = scene.mat_albedo_tex[mat]
        sampler = scene.obj_sampler[obj_i]
        metal_tex = scene.mat_metalness_tex[mat]
        alpha_tex = scene.mat_alpha_tex[mat]

    if scene.n_spheres > 0:
        is_sphere = hit.kind == traverse.KIND_SPHERE
        sphere_i = jnp.where(is_sphere, hit.prim, 0)
        s_center = scene.sphere_pos[sphere_i]
        s_n = hp - s_center
        s_n = s_n / jnp.maximum(
            jnp.linalg.norm(s_n, axis=-1, keepdims=True), 1e-20
        )
        s_n = s_n * jnp.where(front, 1.0, -1.0)[:, None]
        normal = jnp.where(is_sphere[:, None], s_n, normal)
        smat = scene.sphere_mat[sphere_i]
        sp = is_sphere[:, None]
        albedo = jnp.where(sp, scene.mat_albedo[smat], albedo)
        emission = jnp.where(
            sp,
            scene.mat_emission[smat]
            * scene.mat_emission_strength[smat][:, None],
            emission,
        )
        reflectance = jnp.where(
            is_sphere, scene.mat_reflectance[smat], reflectance
        )
        ior = jnp.where(is_sphere, scene.mat_ior[smat], ior)
        tex_id = jnp.where(is_sphere, scene.mat_albedo_tex[smat], tex_id)
        metal_tex = jnp.where(
            is_sphere, scene.mat_metalness_tex[smat], metal_tex
        )
        alpha_tex = jnp.where(is_sphere, scene.mat_alpha_tex[smat], alpha_tex)

    return (hp, normal, uv, albedo, emission, reflectance, ior, tex_id,
            sampler, metal_tex, alpha_tex, front)


def _apply_material_maps(scene, cfg, uv, sampler, albedo, emission,
                         reflectance, tex_id, metal_tex, alpha_tex):
    """Sample albedo/metalness/alpha maps into the per-hit material params.

    Capability extension of reference quirk Q1: the snapshot shader binds
    the maps but never samples them, while its host plumbs map_Kd/map_Ks/
    map_d into per-material slots (``src/vk_engine.cpp:1109-1141``) and the
    gallery proves an earlier shader consumed them (renders/rb_mtlmap.png,
    squeezer_mtlmap.png).  Semantics implemented:

    * albedo map multiplies the material albedo (as before);
    * metalness map's red channel REPLACES ``reflectance`` (the
      reflectance!=0 dispatch then routes bright texels to the mirror
      lobe — rb_mtlmap's metal trim);
    * alpha map's red channel < 0.5 marks the hit as a CUTOUT: the caller
      turns the lane into a pass-through delta bounce (the surface, and
      its emission, are skipped).

    Returns (albedo, emission, reflectance, cutout).
    """
    cutout = jnp.zeros(uv.shape[:1], bool)
    if not (cfg.enable_textures and scene.meta.get("n_textures", 0) > 0):
        return albedo, emission, reflectance, cutout
    tex_rgb = _sample_texture(scene, tex_id, uv, sampler)
    albedo = jnp.where((tex_id >= 0)[:, None], albedo * tex_rgb, albedo)
    if scene.meta.get("n_metalness_maps", 0) > 0:
        m_rgb = _sample_texture(scene, metal_tex, uv, sampler)
        reflectance = jnp.where(metal_tex >= 0, m_rgb[:, 0], reflectance)
    if scene.meta.get("n_alpha_maps", 0) > 0:
        a_rgb = _sample_texture(scene, alpha_tex, uv, sampler)
        cutout = (alpha_tex >= 0) & (a_rgb[:, 0] < 0.5)
        emission = jnp.where(cutout[:, None], 0.0, emission)
    return albedo, emission, reflectance, cutout


def _sample_texture(scene: CompiledScene, tex_id, uv, sampler):
    """Bilinear/nearest fetch from the padded texture stack.

    Capability extension (quirk Q1): the reference snapshot plumbs
    ``texture2D[64]`` + 2 samplers but never calls ``texture()``; earlier
    builds did (renders/dread_texture.png), so real sampling is implemented
    here.  v is flipped (OBJ uv origin bottom-left vs row-major images).
    """
    tid = jnp.maximum(tex_id, 0)
    hw = scene.tex_size[tid].astype(jnp.float32)  # (N,2) = (h,w)
    h, w_ = hw[:, 0], hw[:, 1]
    u = uv[:, 0] - jnp.floor(uv[:, 0])
    v = uv[:, 1] - jnp.floor(uv[:, 1])
    fx = u * w_ - 0.5
    fy = (1.0 - v) * h - 0.5

    def fetch(ix, iy):
        ix = jnp.clip(ix, 0, (w_ - 1).astype(jnp.int32))
        iy = jnp.clip(iy, 0, (h - 1).astype(jnp.int32))
        srgb = scene.tex_data[tid, iy, ix].astype(jnp.float32) / 255.0
        # hardware SRGB-view decode equivalent (vk_engine.cpp:1158)
        return jnp.where(
            srgb <= 0.04045,
            srgb / 12.92,
            ((srgb + 0.055) / 1.055) ** 2.4,
        )

    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    ax = (fx - x0)[:, None]
    ay = (fy - y0)[:, None]
    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    bilinear = (
        c00 * (1 - ax) * (1 - ay)
        + c10 * ax * (1 - ay)
        + c01 * (1 - ax) * ay
        + c11 * ax * ay
    )
    nearest = fetch(
        jnp.round(fx).astype(jnp.int32), jnp.round(fy).astype(jnp.int32)
    )
    return jnp.where((sampler == 1)[:, None], bilinear, nearest)


def trace(
    scene: CompiledScene,
    rays: CameraRays,
    pixel_id: jnp.ndarray,
    frame: jnp.ndarray,
    sample: jnp.ndarray,
    cfg: RenderConfig,
    with_stats: bool = False,
    with_profile: bool = False,
    with_heatmap: bool = False,
):
    """Path-trace one sample for a batch of rays -> (N,3) linear radiance.

    With ``with_stats`` also returns the number of traversals actually
    performed (main + NEE shadow rays) — the Mrays/s numerator, the
    analogue of the reference's ``stats[2]`` counters (raytrace.comp:276).

    With ``with_heatmap`` also returns per-lane ``(box_tests, tri_tests)``
    accumulated over the FULL path — primary, every bounce, and the NEE
    shadow rays — exactly the reference's stats threading
    (raytrace.comp:276,310,338 via :496 and :443).  Traversals route
    through the counting gather walk (same paths, same hits), so this mode
    is for diagnostics, not throughput.

    With ``with_profile`` additionally returns per-bounce occupancy counts
    ``(alive[j], nee_active[j])`` stacked over the bounce scan — the
    wavefront-utilization diagnostic behind the compaction design."""
    n = rays.origin.shape[0]
    f3 = lambda v: jnp.full((n, 3), v, jnp.float32)

    class Carry(NamedTuple):
        origin: jnp.ndarray
        direction: jnp.ndarray
        hit: traverse.Hit  # closest hit of (origin, direction)
        atten: jnp.ndarray
        total: jnp.ndarray
        direct: jnp.ndarray
        alive: jnp.ndarray
        bad: jnp.ndarray
        n_rays: jnp.ndarray
        box: jnp.ndarray  # () when with_heatmap=False, (N,) when True
        tri: jnp.ndarray

    # Primary traversal once; thereafter each bounce issues ONE combined
    # 2N-ray traversal (next bounce rays ++ NEE shadow rays) — half the
    # traversal launches of the naive loop.  This is output-identical: the
    # reference's 0/1-NEE accounting consumes the NEE result only at the
    # NEXT bounce anyway (raytrace.comp:500-517).  The split-launch
    # (anyhit) path skips the tri->obj mapping gather (raw=True) and
    # shades from the fat shading row.
    rt = cfg.resolved_routing()
    use_raw = bool(cfg.nee_anyhit) and not with_heatmap
    if with_heatmap:
        hit0, (box0, tri0) = traverse.traverse_with_stats(
            scene, rays.origin, rays.direction, jnp.ones((n,), bool)
        )
    else:
        hit0 = traverse.traverse(
            scene, rays.origin, rays.direction, jnp.ones((n,), bool),
            raw=use_raw, routing=rt, need_uv=False,
        )
        box0 = tri0 = jnp.zeros((), jnp.float32)

    init = Carry(
        origin=rays.origin,
        direction=rays.direction,
        hit=hit0,
        atten=f3(1.0),
        total=f3(0.0),
        direct=f3(0.0),
        alive=jnp.ones((n,), bool),
        bad=jnp.zeros((n,), bool),
        n_rays=jnp.zeros((2,), jnp.float32) + n,
        box=box0,
        tri=tri0,
    )

    def bounce(carry: Carry, j):
        hit = carry.hit
        did = carry.alive & hit.did_hit

        (hp, normal, uv, albedo, emission, reflectance, ior, tex_id,
         sampler, metal_tex, alpha_tex, front) = _shade_fetch(
            scene, CameraRays(carry.origin, carry.direction), hit, cfg,
        )
        albedo, emission, reflectance, cutout = _apply_material_maps(
            scene, cfg, uv, sampler, albedo, emission, reflectance,
            tex_id, metal_tex, alpha_tex,
        )

        # ---- pending light resolve (raytrace.comp:500-505)
        was_delta = carry.direct[:, 0] == -1.0
        final_light = jnp.where(was_delta[:, None], emission, carry.direct)
        contrib = final_light + jnp.where(j == 0, 1.0, 0.0) * emission
        total = jnp.where(did[:, None], carry.total + contrib * carry.atten, carry.total)
        # NOTE: the reference adds ``finalLight * attenuation`` and the j==0
        # emission unscaled; attenuation is 1 at j==0 so folding both through
        # ``atten`` is exact.
        bad = carry.bad | (
            did
            & (jnp.any(jnp.isnan(total), axis=-1) | jnp.any(total < 0, axis=-1))
        )

        # ---- escape: environment light (raytrace.comp:531-534)
        esc = carry.alive & ~hit.did_hit
        env_l = env_ops.environment_light(scene, carry.direction)
        total = jnp.where(esc[:, None], total + carry.atten * env_l, total)

        alive = did & ~bad

        # ---- BSDF lobes (branchless; raytrace.comp:507-515)
        u6 = rng.uniforms(cfg.seed, pixel_id, frame, sample, j, 7)
        is_spec = reflectance != 0.0
        is_diel = ~is_spec & (ior != -1.0)
        is_diff = ~is_spec & ~is_diel

        # diffuse: NEE direction (traced in the combined launch below)
        nee_origin = hp + normal * 0.01  # raytrace.comp:432
        l_dir, li, n_lights_w, l_dist = lights.sample_rect_light(
            scene, nee_origin, u6[:, 0], u6[:, 1], u6[:, 2]
        )
        cos_pdf_at_l = bsdf.cosine_hemisphere_pdf(normal, l_dir)

        if cfg.estimator == "uniform":
            # ablation: uniform hemisphere, pdf 1/2pi
            # (renders/importance_sampling/cornell_uniform.png)
            cos_dir = bsdf.uniform_hemisphere_dir(normal, u6[:, 3], u6[:, 4])
            real_cos_pdf = jnp.full((n,), 0.5 * INV_PI)
        else:
            cos_dir = bsdf.cosine_hemisphere_dir(normal, u6[:, 3], u6[:, 4])
            real_cos_pdf = bsdf.cosine_hemisphere_pdf(normal, cos_dir)
        rad_diff = (
            albedo
            * INV_PI
            * (dot(normal, cos_dir) / jnp.maximum(real_cos_pdf, 1e-20))[:, None]
        )
        # NEE prefactor; multiplied by the light-side terms once the shadow
        # ray returns (after the combined traversal).
        nee_k = albedo * (INV_PI * jnp.maximum(0.0, dot(normal, l_dir)))[:, None]

        # specular
        dir_spec = intersect.reflect(carry.direction, normal)

        # dielectric (raytrace.comp:471-481)
        ior_eff = jnp.where(front, 1.0 / ior, ior)
        cosine = dot(-carry.direction, normal)
        sine = jnp.sqrt(jnp.maximum(0.0, 1.0 - cosine * cosine))
        solution = (ior_eff * sine > 1.0) | (
            bsdf.schlick(cosine, ior_eff) > u6[:, 5]
        )
        dir_diel = jnp.where(
            solution[:, None],
            dir_spec,
            intersect.refract(carry.direction, normal, ior_eff),
        )
        sign_diel = jnp.where(
            solution, 1.0, jnp.sign(dot(normal, carry.direction))
        )

        # ---- select lobe
        new_dir = jnp.where(
            is_spec[:, None],
            dir_spec,
            jnp.where(is_diel[:, None], dir_diel, cos_dir),
        )
        # secondary-lobe tint: snapshot-exact vec3(1) unless the capability
        # extension is on (RenderConfig.tint_spec_diel)
        sec_rad = albedo if cfg.tint_spec_diel else 1.0
        radiance = jnp.where(is_diff[:, None], rad_diff, sec_rad)
        origin_sign = jnp.where(is_diel, sign_diel, 1.0)
        # alpha cutout: the surface is skipped — a pass-through delta
        # bounce (same direction, radiance 1, no NEE; emission already
        # zeroed in _apply_material_maps)
        new_dir = jnp.where(cutout[:, None], carry.direction, new_dir)
        radiance = jnp.where(cutout[:, None], 1.0, radiance)
        is_diff = is_diff & ~cutout

        atten = carry.atten * jnp.where(alive[:, None], radiance, 1.0)

        # ---- russian roulette (raytrace.comp:519-524)
        rr = jnp.minimum(jnp.max(atten, axis=-1), cfg.rr_clamp)
        rr = jnp.where(j <= cfg.rr_start_bounce, 1.0, rr)
        killed = u6[:, 6] > rr
        alive = alive & ~killed
        atten = atten / jnp.maximum(rr, 1e-20)[:, None]

        # The last bounce's traced results are never consumed (the reference
        # prepares-but-never-traces the next ray, and its final pending NEE
        # is dropped when the loop ends, raytrace.comp:495-530).
        alive = alive & (j < cfg.bounce_limit)
        # Shadow rays whose surface faces AWAY from the sampled light
        # point contribute exactly zero (nee_k clamps the cosine), so
        # skip TRAVERSING them — output-identical; the backside-of-light
        # case (negative pdf -> bad-sample zeroing, raytrace.comp:460)
        # still traces.  ``nee_sem`` keeps the full semantic set for the
        # ray counter: these rays ARE resolved (analytically, to zero) —
        # the reference traverses every one (raytrace.comp:443), so the
        # delivered workload is identical and Mrays/s stays comparable.
        nee_sem = alive & is_diff
        nee_active = nee_sem & (dot(normal, l_dir) > 0.0)
        if cfg.estimator != "mis":
            # ablation modes shoot no shadow rays; emission is collected
            # when the scattered ray hits an emitter (delta-style -1
            # sentinel for every lobe, set below)
            nee_active = jnp.zeros_like(nee_active)
            nee_sem = jnp.zeros_like(nee_sem)

        new_origin = hp + normal * (origin_sign * 1e-5)[:, None]
        new_origin = jnp.where(
            cutout[:, None], hp + carry.direction * 1e-4, new_origin
        )
        new_origin = jnp.where(alive[:, None], new_origin, carry.origin)
        new_dir = jnp.where(alive[:, None], new_dir, carry.direction)

        # heatmap mode forces the fused counting-walk branch below
        anyhit = bool(cfg.nee_anyhit) and not with_heatmap
        box_acc, tri_acc = carry.box, carry.tri
        if (anyhit and scene.n_lights == 0) or (
            cfg.estimator != "mis" and not with_heatmap
        ):
            # No rect lights: NEE can never contribute (the closest-hit
            # resolve would always find pdf=0), so skip the shadow launch
            # entirely.  ``direct`` still becomes 0 (not the -1 delta
            # sentinel) after diffuse bounces, preserving the reference's
            # 0/1-NEE emission suppression (raytrace.comp:500-505).
            hit_next = traverse.traverse(
                scene, new_origin, new_dir, alive, raw=use_raw, routing=rt,
                need_uv=False,
            )
            nee_active = jnp.zeros_like(nee_active)
            nee_sem = jnp.zeros_like(nee_sem)
            l_emit = f3(0.0)
            real_l_pdf = jnp.zeros((n,), jnp.float32)
        elif anyhit:
            # ---- split launches: closest-hit bounce rays + ANY-HIT shadow
            # rays.  Shadow lanes terminate at their first hit inside the
            # clip (no closest-hit refinement), and the light-side pdf is
            # analytic at the sampled distance — the value the reference's
            # raycast returns when unoccluded (raytrace.comp:396-402).
            # Deviation (documented): an emissive surface strictly BETWEEN
            # the shading point and the sampled light counts as an occluder
            # here, where the reference would credit ITS emission instead;
            # scenes whose only emitters are the light rects (all presets,
            # and everything the reference ships) are unaffected.
            hit_next = traverse.traverse(
                scene, new_origin, new_dir, alive, raw=use_raw, routing=rt,
                need_uv=False,
            )
            occluded = traverse.traverse_anyhit(
                scene, nee_origin, l_dir, nee_active,
                tmax=l_dist * (1.0 - 1e-3), routing=rt,
            )
            reached = nee_active & ~occluded
            l_emit = lights.rect_light_emission(scene, li)
            real_l_pdf = jnp.where(
                reached,
                lights.rect_light_pdf_analytic(scene, li, l_dir, l_dist),
                0.0,
            )
        else:
            # ---- ONE combined traversal: next bounce rays ++ NEE shadow
            # rays, both closest-hit (the reference-shaped resolve).
            o_both = jnp.concatenate([new_origin, nee_origin])
            d_both = jnp.concatenate([new_dir, l_dir])
            a_both = jnp.concatenate([alive, nee_active])
            # Shadow rays are clipped just past the sampled light point so
            # traversal prunes subtrees beyond the light.  Deliberate
            # deviation (like the anyhit path's, documented above): the
            # reference's unclipped raycast would count an emissive surface
            # BEYOND the sampled distance (second emitter behind the light,
            # or a light-table rect not coinciding with geometry,
            # raytrace.comp:396-402) — impossible in scenes whose rect
            # lights coincide with their emissive quads, i.e. every preset
            # and everything the reference ships.
            nee_tmax = l_dist * 1.002 + 1e-3
            t_both = jnp.concatenate(
                [jnp.full((n,), intersect.BIG), nee_tmax]
            )
            do_sort = cfg.sort_bounce_rays
            if do_sort is None:
                do_sort = False  # auto = off
            if with_heatmap:
                # Counting walk; shadow-lane counts fold into their pixel
                # (the reference threads one stats[2] through main and NEE
                # traversals alike, raytrace.comp:443,496).
                both, (sb, st) = traverse.traverse_with_stats(
                    scene, o_both, d_both, a_both, tmax=t_both
                )
                box_acc = carry.box + sb[:n] + sb[n:]
                tri_acc = carry.tri + st[:n] + st[n:]
            elif do_sort:
                # Alive-first compaction: a stable two-bucket partition (one
                # cumsum, no argsort).  Dead lanes cluster at the tail;
                # per-lane results are order-independent, un-permuted after.
                alive_i = a_both.astype(jnp.int32)
                n_alive = jnp.sum(alive_i)
                pos_alive = jnp.cumsum(alive_i) - 1
                pos_dead = n_alive + jnp.cumsum(1 - alive_i) - 1
                dest = jnp.where(a_both, pos_alive, pos_dead)
                order = jnp.zeros_like(dest).at[dest].set(
                    jnp.arange(dest.shape[0], dtype=dest.dtype),
                    unique_indices=True,
                )
                both = traverse.traverse(
                    scene, o_both[order], d_both[order], a_both[order],
                    tmax=t_both[order], routing=rt, need_uv=False,
                )
                both = jax.tree.map(lambda x: x[dest], both)
            else:
                both = traverse.traverse(
                    scene, o_both, d_both, a_both, tmax=t_both, routing=rt,
                    need_uv=False,
                )
            hit_next = jax.tree.map(lambda x: x[:n], both)
            nee_hit = jax.tree.map(lambda x: x[n:], both)

            # ---- NEE resolve (becomes next bounce's pending directLight)
            nee_mat = jnp.where(
                nee_hit.kind == traverse.KIND_SPHERE,
                scene.sphere_mat[jnp.where(nee_hit.kind == traverse.KIND_SPHERE, nee_hit.prim, 0)],
                scene.obj_mat[jnp.where(nee_hit.kind == traverse.KIND_TRI, nee_hit.obj, 0)],
            )
            nee_mat = jnp.where(nee_hit.did_hit, nee_mat, 0).astype(jnp.int32)
            nee_strength = scene.mat_emission_strength[nee_mat]
            l_emit = scene.mat_emission[nee_mat] * nee_strength[:, None]
            hit_emissive = nee_hit.did_hit & (nee_strength > 0.0)
            real_l_pdf = lights.rect_light_pdf(
                scene, li, l_dir, nee_hit.dst, hit_emissive
            )

        real_l_pdf = real_l_pdf / n_lights_w  # uniform light pick
        w1 = real_l_pdf**2 / (real_l_pdf**2 + cos_pdf_at_l**2)
        w1 = jnp.where(jnp.isnan(w1), 0.0, w1)  # raytrace.comp:450
        # Sign-preserving divide: a NEGATIVE pdf (light sampled from its
        # back side) must yield a negative contribution that trips the
        # bad-sample zeroing below, exactly like the reference
        # (raytrace.comp:460,505) — clamping it positive would inject an
        # unbounded firefly instead.
        direct_diff = l_emit * nee_k * jnp.where(
            real_l_pdf == 0.0, 0.0, w1 / real_l_pdf
        )[:, None]
        if cfg.estimator == "mis":
            new_direct = jnp.where(is_diff[:, None], direct_diff, -1.0)
        else:
            # no NEE: every lobe defers to next-hit emission
            new_direct = jnp.full((n, 3), -1.0)
        direct = jnp.where((did & ~bad)[:, None], new_direct, carry.direct)

        # Ray accounting rides a (2,) vector: [0] = SEMANTIC rays (every
        # ray the reference would traverse, raytrace.comp:443 — the
        # Mrays/s denominator), [1] = rays actually TRAVERSED (facing-away
        # NEE lanes are resolved analytically and never launched; both are
        # reported so the analytic resolve can't inflate throughput).
        n_alive = jnp.sum(alive.astype(jnp.float32))
        n_rays = carry.n_rays + jnp.stack(
            [
                n_alive + jnp.sum(nee_sem.astype(jnp.float32)),
                n_alive + jnp.sum(nee_active.astype(jnp.float32)),
            ]
        )

        out = Carry(
            origin=new_origin,
            direction=new_dir,
            hit=hit_next,
            atten=atten,
            total=total,
            direct=direct,
            alive=alive,
            bad=bad,
            n_rays=n_rays,
            box=box_acc,
            tri=tri_acc,
        )
        ys = None
        if with_profile:
            ys = (
                jnp.sum(alive.astype(jnp.float32)),
                jnp.sum(nee_active.astype(jnp.float32)),
            )
        return out, ys

    final, per_bounce = jax.lax.scan(
        bounce, init, jnp.arange(cfg.bounce_limit + 1, dtype=jnp.int32)
    )
    color = jnp.where(final.bad[:, None], 0.0, final.total)
    if with_heatmap:
        return color, (final.box, final.tri)
    if with_profile:
        return color, final.n_rays, per_bounce
    if with_stats:
        return color, final.n_rays
    return color


def _resolve_direct(real_l_pdf, n_lights_w, cos_pdf_at_l, l_emit, nee_k,
                    is_diff, fresh_direct, direct_base):
    """MIS light-sample resolve -> next round's pending ``direct``.

    The power-heuristic light-side weight and the 0/1-NEE delta sentinel
    (raytrace.comp:449-456,500-505); shared by the pre-permute (anyhit)
    and post-traversal (closest-hit) resolve paths, which differ only in
    where ``real_l_pdf`` comes from.
    """
    real_l_pdf = real_l_pdf / n_lights_w
    w1 = real_l_pdf**2 / (real_l_pdf**2 + cos_pdf_at_l**2)
    w1 = jnp.where(jnp.isnan(w1), 0.0, w1)
    direct_diff = l_emit * nee_k * jnp.where(
        real_l_pdf == 0.0, 0.0, w1 / real_l_pdf
    )[:, None]
    new_direct = jnp.where(is_diff[:, None], direct_diff, -1.0)
    return jnp.where(fresh_direct[:, None], new_direct, direct_base)


def _bin_key(scene: CompiledScene, origin, direction, alive, mb=5, db=0):
    """Traversal-coherence sort key: (direction octant [+ optional finer
    direction bits], origin morton cell).

    Rays sharing a key traverse near-identical BVH subtrees, so sorting by
    it puts rays with similar walks in neighbouring lanes.  Dead lanes key
    to the end.  Bounds come from the flattened BVH root box; forest
    scenes degrade to octant-only.

    ``mb``: morton bits per origin axis (default 5 = 32^3 cells).
    ``db``: extra |direction| quantization bits per axis inside the octant
    (default 0).  Both from Routing.
    """
    oct_ = (
        (direction[:, 0] < 0).astype(jnp.int32)
        + 2 * (direction[:, 1] < 0).astype(jnp.int32)
        + 4 * (direction[:, 2] < 0).astype(jnp.int32)
    )
    key = oct_ << (3 * mb + 3 * db)
    if db:
        dq = jnp.clip(
            jnp.abs(direction) * (1 << db), 0, (1 << db) - 1
        ).astype(jnp.int32)
        dmix = (dq[:, 0] << (2 * db)) | (dq[:, 1] << db) | dq[:, 2]
        key = key | (dmix << (3 * mb))
    if scene.meta.get("flattened", False) and scene.meta.get("n_tris", 0):
        root = scene.bvh_packed[scene.obj_bvh_root[0]]
        mn, mx = root[0:3], root[3:6]
        cell = jnp.clip(
            ((origin - mn) / jnp.maximum(mx - mn, 1e-6)) * (1 << mb),
            0.0,
            float((1 << mb) - 1),
        ).astype(jnp.int32)
        morton = jnp.zeros_like(oct_)
        for b in range(mb):
            for ax in range(3):
                morton = morton | (((cell[:, ax] >> b) & 1) << (3 * b + ax))
        key = key | morton
    return jnp.where(alive, key, jnp.int32(1) << 30)


def _lane_groups(n_lanes: int, n_spp: int, cfg: RenderConfig) -> int:
    """Sample-split factor g for the spp-lane population mode.

    Splits each pixel's ``n_spp`` samples across ``g`` lanes (each lane
    regenerates ``n_spp // g`` samples) so the wavefront's population
    grows g-fold: more independent paths per launch, and a larger pool
    for coherence binning.

    Prefers g = n_spp (the left-fold group sum then reproduces the
    sequential sample order); otherwise the largest divisor of n_spp
    that keeps total lanes within ``cfg.lane_pool``.  The sampled paths
    are identical either way (RNG streams are keyed on (pixel, sample));
    images agree to float-scheduling tolerance only, because the
    expanded lane count compiles a different XLA program (reassociated
    FMAs — the same allowance as batch-shape tiling, quirk Q9 tests).
    """
    pool = cfg.lane_pool if cfg.lane_pool else (1 << 23)
    cap = max(1, pool // max(n_lanes, 1))
    if cap >= n_spp:
        return n_spp
    for d in range(cap, 1, -1):
        if n_spp % d == 0:
            return d
    return 1


def trace_wave(
    scene: CompiledScene,
    rot,
    pos,
    fov,
    aspect,
    near,
    pixel_id: jnp.ndarray,
    frame: jnp.ndarray,
    sample_base: jnp.ndarray,
    n_spp: int,
    cfg: RenderConfig,
    with_stats: bool = False,
):
    """All ``n_spp`` samples of each pixel — lane-pooled when profitable.

    Expands to ``g = _lane_groups(...)`` lanes per pixel (each owning a
    contiguous run of sample indices via its per-lane ``sample_base``)
    before entering the wavefront, then folds the g per-group sums back
    per pixel in ascending-k order.  Per-sample radiances come from the
    same counter-based RNG streams keyed on (pixel, sample), so the
    sampled paths are identical; values shift only at float-scheduling
    level (see _lane_groups).
    """
    n = pixel_id.shape[0]
    g = _lane_groups(n, n_spp, cfg)
    if g <= 1:
        return _trace_wave_lanes(
            scene, rot, pos, fov, aspect, near, pixel_id, frame,
            sample_base, n_spp, cfg, with_stats,
        )
    per = n_spp // g
    base = jnp.broadcast_to(jnp.asarray(sample_base, jnp.int32), (n,))
    pix_g = jnp.concatenate([pixel_id.astype(jnp.int32)] * g)
    base_g = jnp.concatenate([base + jnp.int32(k * per) for k in range(g)])
    out = _trace_wave_lanes(
        scene, rot, pos, fov, aspect, near, pix_g, frame, base_g, per,
        cfg, with_stats,
    )
    lanes = out[0] if with_stats else out
    acc = lanes[:n]
    for k in range(1, g):  # ordered left fold = sequential sample order
        acc = acc + lanes[k * n:(k + 1) * n]
    return (acc, out[1]) if with_stats else acc


def _trace_wave_lanes(
    scene: CompiledScene,
    rot,
    pos,
    fov,
    aspect,
    near,
    pixel_id: jnp.ndarray,
    frame: jnp.ndarray,
    sample_base: jnp.ndarray,
    n_spp: int,
    cfg: RenderConfig,
    with_stats: bool = False,
):
    """All ``n_spp`` samples of each pixel, with PATH REGENERATION.

    Radiometrically identical to summing :func:`render_sample` over the
    sample index (identical counter-based RNG streams and per-lane state
    machine; per-lane traversal results are independent of lane
    order), but scheduled as ONE ``lax.while_loop`` in which a lane
    whose path terminates immediately begins its pixel's next sample.

    Why: with a static bounce scan the wavefront decays with bounce depth
    (most lanes of late bounces are dead).  Regeneration keeps lanes
    ~full: the per-round cost is paid ~E[path length]*spp times instead of
    (bounce_limit+1)*spp times.  It replaces the ray compaction the
    reference's planned-but-absent wavefront mode would have used
    (README.md:13-16) with per-lane rescheduling, no permutes.

    Returns the per-pixel color SUM over samples (N,3) — divide by
    ``n_spp`` for the mean — plus the traversal-event count when
    ``with_stats``.
    """
    n = pixel_id.shape[0]
    f3 = lambda v: jnp.full((n, 3), v, jnp.float32)
    rt = cfg.resolved_routing()

    do_bin = bool(cfg.bin_rays)  # auto (None) = off

    def primary_rays(pix, s):
        """Camera rays for per-lane (pixel, sample index) pairs (N,)."""
        jitter = None
        if cfg.aa_jitter:
            j2 = rng.uniforms(cfg.seed ^ 0xA11A5, pix, frame, s, 999, 2)
            jitter = j2 - 0.5
        return raygen(
            rot, pos, fov, aspect, near, pix, cfg.width, cfg.height,
            jitter,
        )

    class Wave(NamedTuple):
        origin: jnp.ndarray  # (N,3) ray of the PENDING hit
        direction: jnp.ndarray
        hit: traverse.Hit
        atten: jnp.ndarray
        total: jnp.ndarray
        direct: jnp.ndarray
        bad: jnp.ndarray
        alive: jnp.ndarray  # (N,) lane has a pending hit to shade
        j: jnp.ndarray  # (N,) i32 bounce index of the pending hit
        s: jnp.ndarray  # (N,) i32 sample index (== n_spp -> retired)
        sb: jnp.ndarray  # (N,) i32 per-lane sample-index base (rides permutes;
        #   scalar ``sample_base`` broadcasts here, so lanes may each own a
        #   DIFFERENT sample of the same pixel — the spp-lane population mode)
        acc: jnp.ndarray  # (N,3) banked color sum of completed samples
        pix: jnp.ndarray  # (N,) i32 pixel id of the lane (rides permutes)
        slot: jnp.ndarray  # (N,) i32 original lane (output position)
        n_rays: jnp.ndarray

    use_raw = bool(cfg.nee_anyhit)
    s0 = jnp.zeros((n,), jnp.int32)
    sb0 = jnp.broadcast_to(jnp.asarray(sample_base, jnp.int32), (n,))
    pix0 = jnp.asarray(pixel_id, jnp.int32)
    rays0 = primary_rays(pix0, sb0 + s0)
    hit0 = traverse.traverse(
        scene, rays0.origin, rays0.direction, jnp.ones((n,), bool),
        raw=use_raw, routing=rt, need_uv=False,
    )
    init = Wave(
        origin=rays0.origin,
        direction=rays0.direction,
        hit=hit0,
        atten=f3(1.0),
        total=f3(0.0),
        direct=f3(0.0),
        bad=jnp.zeros((n,), bool),
        alive=jnp.ones((n,), bool),
        j=jnp.zeros((n,), jnp.int32),
        s=s0,
        sb=sb0,
        acc=f3(0.0),
        pix=pix0,
        slot=jnp.arange(n, dtype=jnp.int32),
        n_rays=jnp.zeros((2,), jnp.float32) + n,
    )

    def cond(w: Wave):
        return jnp.any(w.alive)

    def round_(w: Wave) -> Wave:
        hit = w.hit
        j = w.j
        sample = w.sb + w.s
        did = w.alive & hit.did_hit

        (hp, normal, uv, albedo, emission, reflectance, ior, tex_id,
         sampler, metal_tex, alpha_tex, front) = _shade_fetch(
            scene, CameraRays(w.origin, w.direction), hit, cfg
        )
        albedo, emission, reflectance, cutout = _apply_material_maps(
            scene, cfg, uv, sampler, albedo, emission, reflectance,
            tex_id, metal_tex, alpha_tex,
        )

        # ---- pending light resolve (raytrace.comp:500-505)
        was_delta = w.direct[:, 0] == -1.0
        final_light = jnp.where(was_delta[:, None], emission, w.direct)
        contrib = (
            final_light + jnp.where(j == 0, 1.0, 0.0)[:, None] * emission
        )
        total = jnp.where(did[:, None], w.total + contrib * w.atten, w.total)
        bad = w.bad | (
            did
            & (
                jnp.any(jnp.isnan(total), axis=-1)
                | jnp.any(total < 0, axis=-1)
            )
        )

        # ---- escape: environment light (raytrace.comp:531-534)
        esc = w.alive & ~hit.did_hit
        env_l = env_ops.environment_light(scene, w.direction)
        total = jnp.where(esc[:, None], total + w.atten * env_l, total)

        shaded = did & ~bad

        # ---- BSDF lobes (branchless; raytrace.comp:507-515)
        u6 = rng.uniforms(cfg.seed, w.pix, frame, sample, j, 7)
        is_spec = reflectance != 0.0
        is_diel = ~is_spec & (ior != -1.0)
        is_diff = ~is_spec & ~is_diel

        nee_origin = hp + normal * 0.01  # raytrace.comp:432
        l_dir, li, n_lights_w, l_dist = lights.sample_rect_light(
            scene, nee_origin, u6[:, 0], u6[:, 1], u6[:, 2]
        )
        cos_pdf_at_l = bsdf.cosine_hemisphere_pdf(normal, l_dir)

        cos_dir = bsdf.cosine_hemisphere_dir(normal, u6[:, 3], u6[:, 4])
        real_cos_pdf = bsdf.cosine_hemisphere_pdf(normal, cos_dir)
        rad_diff = (
            albedo
            * INV_PI
            * (dot(normal, cos_dir) / jnp.maximum(real_cos_pdf, 1e-20))[
                :, None
            ]
        )
        nee_k = albedo * (INV_PI * jnp.maximum(0.0, dot(normal, l_dir)))[
            :, None
        ]

        dir_spec = intersect.reflect(w.direction, normal)
        ior_eff = jnp.where(front, 1.0 / ior, ior)
        cosine = dot(-w.direction, normal)
        sine = jnp.sqrt(jnp.maximum(0.0, 1.0 - cosine * cosine))
        solution = (ior_eff * sine > 1.0) | (
            bsdf.schlick(cosine, ior_eff) > u6[:, 5]
        )
        dir_diel = jnp.where(
            solution[:, None],
            dir_spec,
            intersect.refract(w.direction, normal, ior_eff),
        )
        sign_diel = jnp.where(
            solution, 1.0, jnp.sign(dot(normal, w.direction))
        )

        new_dir = jnp.where(
            is_spec[:, None],
            dir_spec,
            jnp.where(is_diel[:, None], dir_diel, cos_dir),
        )
        # secondary-lobe tint: snapshot-exact vec3(1) unless the capability
        # extension is on (RenderConfig.tint_spec_diel)
        sec_rad = albedo if cfg.tint_spec_diel else 1.0
        radiance = jnp.where(is_diff[:, None], rad_diff, sec_rad)
        origin_sign = jnp.where(is_diel, sign_diel, 1.0)
        # alpha cutout: pass-through delta bounce (see _apply_material_maps)
        new_dir = jnp.where(cutout[:, None], w.direction, new_dir)
        radiance = jnp.where(cutout[:, None], 1.0, radiance)
        is_diff = is_diff & ~cutout
        atten = w.atten * jnp.where(shaded[:, None], radiance, 1.0)

        # ---- russian roulette (raytrace.comp:519-524)
        rr = jnp.minimum(jnp.max(atten, axis=-1), cfg.rr_clamp)
        rr = jnp.where(j <= cfg.rr_start_bounce, 1.0, rr)
        killed = u6[:, 6] > rr
        atten = atten / jnp.maximum(rr, 1e-20)[:, None]

        continuing = shaded & ~killed & (j < cfg.bounce_limit)
        # Facing-away shadow rays contribute exactly zero, so they are
        # resolved analytically instead of traversed (see trace()); the
        # scalar semantic count is taken HERE, before the binning permute
        # (sums are permutation-invariant), so no extra column rides the
        # packed state.
        nee_sem = continuing & is_diff
        nee_active = nee_sem & (dot(normal, l_dir) > 0.0)
        # semantic vs traced NEE counts (see trace()'s n_rays comment);
        # both are taken pre-binning — sums are permutation-invariant.
        if not (cfg.nee_anyhit and scene.n_lights == 0):
            n_nee_sem = jnp.sum(nee_sem.astype(jnp.float32))
            n_nee_act = jnp.sum(nee_active.astype(jnp.float32))
        else:
            n_nee_sem = jnp.float32(0.0)
            n_nee_act = jnp.float32(0.0)

        # ---- sample completion + regeneration
        path_ends = w.alive & ~continuing
        sample_color = jnp.where(bad[:, None], 0.0, total)
        acc = w.acc + jnp.where(path_ends[:, None], sample_color, 0.0)
        s_new = w.s + path_ends.astype(jnp.int32)
        regen = path_ends & (s_new < n_spp)

        prim = primary_rays(w.pix, w.sb + s_new)
        bounce_origin = hp + normal * (origin_sign * 1e-5)[:, None]
        bounce_origin = jnp.where(
            cutout[:, None], hp + w.direction * 1e-4, bounce_origin
        )
        new_origin = jnp.where(
            continuing[:, None],
            bounce_origin,
            jnp.where(regen[:, None], prim.origin, w.origin),
        )
        new_dir = jnp.where(
            continuing[:, None],
            new_dir,
            jnp.where(regen[:, None], prim.direction, w.direction),
        )
        alive = continuing | regen
        j_new = jnp.where(continuing, j + 1, 0)
        # fresh-path state for regenerated lanes
        total = jnp.where(path_ends[:, None], 0.0, total)
        atten = jnp.where(path_ends[:, None], 1.0, atten)
        bad = jnp.where(path_ends, False, bad)

        # ---- post-NEE ``direct`` ingredients (resolved after traversal)
        fresh_direct = shaded & ~path_ends  # lanes taking this round's NEE
        direct_base = jnp.where(path_ends[:, None], 0.0, w.direct)
        pix, slot, s_cur, j_cur, sb_cur = w.pix, w.slot, s_new, j_new, w.sb

        # ---- pre-permute NEE (Routing.nee_prebin): the anyhit shadow
        # query + MIS resolve run HERE, before the round's state permute —
        # "sort" additionally bins the shadow rays by their OWN key
        # (active-first, shadow-direction octant), "nosort" keeps
        # main-wave order (previous round's bounce coherence).
        # ``direct`` is then fully resolved and rides the main permute as
        # 3 columns, dropping the 12 NEE columns from the packed
        # row-gather.  Bit-identical: per-lane traversal results
        # are permutation-invariant and every op here is elementwise.
        prebin = bool(cfg.nee_anyhit) and rt.nee_prebin != "off"
        if prebin:
            if scene.n_lights == 0:
                # NEE can never contribute (see the non-prebin branch
                # below); the resolve still runs so ``direct`` carries
                # the 0-vs-(-1) delta sentinel pattern.
                l_emit = jnp.zeros_like(nee_k)
                real_l_pdf = jnp.zeros_like(l_dist)
            else:
                clip = l_dist * (1.0 - 1e-3)
                if do_bin and rt.nee_prebin == "sort":
                    key2 = _bin_key(
                        scene, nee_origin, l_dir, nee_active,
                        rt.bin_bits, rt.bin_dir_bits,
                    )
                    order2 = jnp.argsort(key2)
                    occ_b = traverse.traverse_anyhit(
                        scene, nee_origin[order2], l_dir[order2],
                        nee_active[order2], tmax=clip[order2], routing=rt,
                    )
                    occluded = jnp.zeros_like(occ_b).at[order2].set(
                        occ_b, unique_indices=True
                    )
                else:
                    occluded = traverse.traverse_anyhit(
                        scene, nee_origin, l_dir, nee_active, tmax=clip,
                        routing=rt,
                    )
                reached = nee_active & ~occluded
                l_emit = lights.rect_light_emission(scene, li)
                real_l_pdf = jnp.where(
                    reached,
                    lights.rect_light_pdf_analytic(scene, li, l_dir, l_dist),
                    0.0,
                )
            direct = _resolve_direct(
                real_l_pdf, n_lights_w, cos_pdf_at_l, l_emit, nee_k,
                is_diff, fresh_direct, direct_base,
            )

        if do_bin:
            # ---- coherence binning: permute every live per-lane value so
            # neighbouring lanes share (octant, origin cell).  One packed
            # (N, 36) f32 row-gather + one (N, 5) i32 row-gather move the
            # whole state; per-lane results are permutation-invariant, so
            # images are bit-identical.  Integer lane state (pix, slot, j,
            # s, li) rides the i32 pack — pix is a global pixel id, and a
            # float32 round-trip would corrupt ids >= 2^24 (8K frames).
            if rt.bin_mode == "leaf":
                # Geometry-adaptive key: bounce
                # lanes key by (direction octant, previous-hit primitive
                # id) — prim ids follow the builder's DFS order, an
                # adaptive space-filling curve over the geometry, so
                # same-key lanes share a leaf-scale surface patch where a
                # bin_bits-morton cell can span thousands of leaves.
                # Regenerated camera lanes key by pixel id (scanline
                # coherence).
                oct_ = (
                    (new_dir[:, 0] < 0).astype(jnp.int32)
                    + 2 * (new_dir[:, 1] < 0).astype(jnp.int32)
                    + 4 * (new_dir[:, 2] < 0).astype(jnp.int32)
                )
                pk = jnp.clip(hit.prim, 0, (1 << 24) - 1)
                pk = jnp.where(
                    hit.kind == traverse.KIND_SPHERE, (1 << 24) - 64 + pk,
                    pk,
                )
                key = jnp.where(
                    continuing,
                    (oct_ << 24) | pk,
                    (jnp.int32(1) << 29) | pix,
                )
                key = jnp.where(alive, key, jnp.int32(1) << 30)
                order = jnp.argsort(key)
            elif rt.bin_mode == "hier":
                # Hierarchical key: the default (octant, morton-cell) is
                # the PRIMARY order, so neighbouring lanes stay
                # subtree-local, and lanes inside each cell are sub-ordered
                # by previous-hit prim id (DFS leaf locality).  Two stable
                # argsorts realize the 30+bit composite inside int32 keys.
                # Pure re-permutation: bit-identical.
                key = _bin_key(
                    scene, new_origin, new_dir, alive, rt.bin_bits,
                    rt.bin_dir_bits,
                )
                pk = jnp.clip(hit.prim, 0, (1 << 24) - 1)
                pk = jnp.where(
                    hit.kind == traverse.KIND_SPHERE, (1 << 24) - 64 + pk,
                    pk,
                )
                sub = jnp.where(continuing, pk, pix)
                order_pre = jnp.argsort(sub)
                order = order_pre[jnp.argsort(key[order_pre], stable=True)]
            else:
                key = _bin_key(
                    scene, new_origin, new_dir, alive, rt.bin_bits,
                    rt.bin_dir_bits,
                )
                order = jnp.argsort(key)
            fi = lambda x: x.astype(jnp.float32)[:, None]
            if prebin:
                # slim pack: NEE already resolved into ``direct`` above
                packed = jnp.concatenate(
                    [
                        new_origin, new_dir, atten, total, acc, direct,
                        fi(alive), fi(bad),
                    ],
                    axis=1,
                )[order]
                packed_i = jnp.stack(
                    [j_cur, s_cur, pix, slot, sb_cur], axis=1
                )[order]
                v3 = lambda k: packed[:, 3 * k : 3 * k + 3]
                (new_origin, new_dir, atten, total, acc, direct) = (
                    v3(k) for k in range(6)
                )
                alive = packed[:, 18] > 0.5
                bad = packed[:, 19] > 0.5
                j_cur, s_cur, pix, slot, sb_cur = (
                    packed_i[:, k] for k in range(5)
                )
            else:
                packed = jnp.concatenate(
                    [
                        new_origin, new_dir, atten, total, acc, direct_base,
                        nee_origin, l_dir, nee_k,  # 27 vector slots
                        fi(alive), fi(bad),
                        fi(fresh_direct), fi(is_diff),
                        cos_pdf_at_l[:, None], l_dist[:, None],
                        fi(nee_active),
                    ],
                    axis=1,
                )[order]
                packed_i = jnp.stack(
                    [j_cur, s_cur, pix, slot, li, sb_cur], axis=1
                )[order]
                v3 = lambda k: packed[:, 3 * k : 3 * k + 3]
                (new_origin, new_dir, atten, total, acc, direct_base,
                 nee_origin, l_dir, nee_k) = (v3(k) for k in range(9))
                col = lambda k: packed[:, 27 + k]
                alive = col(0) > 0.5
                bad = col(1) > 0.5
                fresh_direct = col(2) > 0.5
                is_diff = col(3) > 0.5
                cos_pdf_at_l = col(4)
                l_dist = col(5)
                nee_active = col(6) > 0.5
                j_cur, s_cur, pix, slot, li, sb_cur = (
                    packed_i[:, k] for k in range(6)
                )

        # ---- traverse the merged wavefront (bounce ++ regenerated primary)
        hit_next = traverse.traverse(
                scene, new_origin, new_dir, alive, raw=use_raw, routing=rt,
                need_uv=False,
            )

        # ---- NEE shadow query for continuing diffuse lanes
        if prebin:
            pass  # resolved into ``direct`` before the permute
        elif cfg.nee_anyhit and scene.n_lights == 0:
            nee_active = jnp.zeros_like(nee_active)
            l_emit = jnp.zeros_like(nee_k)
            real_l_pdf = jnp.zeros_like(l_dist)
        elif cfg.nee_anyhit:
            occluded = traverse.traverse_anyhit(
                scene, nee_origin, l_dir, nee_active,
                tmax=l_dist * (1.0 - 1e-3), routing=rt,
            )
            reached = nee_active & ~occluded
            l_emit = lights.rect_light_emission(scene, li)
            real_l_pdf = jnp.where(
                reached,
                lights.rect_light_pdf_analytic(scene, li, l_dir, l_dist),
                0.0,
            )
        else:
            nee_hit = traverse.traverse(
                scene, nee_origin, l_dir, nee_active,
                tmax=l_dist * 1.002 + 1e-3, routing=rt, need_uv=False,
            )
            nee_mat = jnp.where(
                nee_hit.kind == traverse.KIND_SPHERE,
                scene.sphere_mat[
                    jnp.where(
                        nee_hit.kind == traverse.KIND_SPHERE, nee_hit.prim, 0
                    )
                ],
                scene.obj_mat[
                    jnp.where(
                        nee_hit.kind == traverse.KIND_TRI, nee_hit.obj, 0
                    )
                ],
            )
            nee_mat = jnp.where(nee_hit.did_hit, nee_mat, 0).astype(
                jnp.int32
            )
            nee_strength = scene.mat_emission_strength[nee_mat]
            l_emit = scene.mat_emission[nee_mat] * nee_strength[:, None]
            hit_emissive = nee_hit.did_hit & (nee_strength > 0.0)
            real_l_pdf = lights.rect_light_pdf(
                scene, li, l_dir, nee_hit.dst, hit_emissive
            )

        if not prebin:
            direct = _resolve_direct(
                real_l_pdf, n_lights_w, cos_pdf_at_l, l_emit, nee_k,
                is_diff, fresh_direct, direct_base,
            )

        n_alive = jnp.sum(alive.astype(jnp.float32))
        n_rays = w.n_rays + jnp.stack(
            [n_alive + n_nee_sem, n_alive + n_nee_act]
        )
        return Wave(
            origin=new_origin,
            direction=new_dir,
            hit=hit_next,
            atten=atten,
            total=total,
            direct=direct,
            bad=bad,
            alive=alive,
            j=j_cur,
            s=s_cur,
            sb=sb_cur,
            acc=acc,
            pix=pix,
            slot=slot,
            n_rays=n_rays,
        )

    if not do_bin:
        final = jax.lax.while_loop(cond, round_, init)
        if with_stats:
            return final.acc, final.n_rays
        return final.acc

    # ---- multi-phase drain (binned path only).  The while_loop runs at
    # full width until the deepest path retires, so tail rounds pay whole-
    # tile gathers/sorts/traversals at a few percent occupancy.  The bin
    # key orders dead lanes last, so once the alive count fits in width/4
    # the sorted wavefront's live lanes form a PREFIX: bank the retired
    # suffix and keep while-looping on a statically 4x-narrower slice.
    # Multi-phase drain: when the live population falls below the next
    # width, dead lanes (sorted to the tail by the bin key) are banked
    # and the whole wavefront ARRAY shrinks, so late sparse rounds stop
    # paying full-width shading fusions and row-gathers.  The divisor
    # bounds the within-phase occupancy waste (div 4 -> up to 4x);
    # deaths only happen in shading, BEFORE the round's sort, so every
    # live lane sits inside [:next_width] whenever the while exits.
    div = cfg.drain_div if cfg.drain_div else 4
    widths = [n]
    while widths[-1] % div == 0 and widths[-1] // div >= 8192:
        widths.append(widths[-1] // div)

    def slice_wave(w: Wave, m: int) -> Wave:
        f = lambda x: x[:m] if getattr(x, "ndim", 0) >= 1 else x
        return Wave(
            origin=f(w.origin), direction=f(w.direction),
            hit=jax.tree.map(f, w.hit),
            atten=f(w.atten), total=f(w.total), direct=f(w.direct),
            bad=f(w.bad), alive=f(w.alive), j=f(w.j), s=f(w.s),
            sb=f(w.sb), acc=f(w.acc), pix=f(w.pix), slot=f(w.slot),
            n_rays=w.n_rays,
        )

    banked_acc, banked_slot = [], []
    w = init
    for i, width in enumerate(widths):
        nxt = widths[i + 1] if i + 1 < len(widths) else 0
        w = jax.lax.while_loop(
            lambda w, lim=nxt: jnp.sum(w.alive) > lim, round_, w
        )
        if nxt:
            banked_acc.append(w.acc[nxt:])
            banked_slot.append(w.slot[nxt:])
            w = slice_wave(w, nxt)
    banked_acc.append(w.acc)
    banked_slot.append(w.slot)
    # restore positional order (lane i of the output = pixel_id[i])
    acc = jnp.zeros((n, 3), jnp.float32).at[
        jnp.concatenate(banked_slot)
    ].set(jnp.concatenate(banked_acc), unique_indices=True)
    if with_stats:
        return acc, w.n_rays
    return acc


def render_sample(
    scene: CompiledScene,
    cam_rotation,
    cam_pos,
    fov,
    aspect,
    near,
    pixel_id,
    frame,
    sample,
    cfg: RenderConfig,
):
    """One path-traced sample per listed pixel -> (N,3)."""
    jitter = None
    if cfg.aa_jitter:
        j2 = rng.uniforms(cfg.seed ^ 0xA11A5, pixel_id, frame, sample, 999, 2)
        jitter = j2 - 0.5
    rays = raygen(
        cam_rotation, cam_pos, fov, aspect, near, pixel_id, cfg.width, cfg.height,
        jitter,
    )
    return trace(scene, rays, pixel_id, frame, sample, cfg)
