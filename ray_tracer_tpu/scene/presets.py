"""Built-in scenes replicating the reference's hardcoded setups.

``default_materials``/``cornell_box``/``default_scene`` mirror
``prepare_storage_buffers`` + ``cornell_box`` (``src/vk_engine.cpp:638-758``)
— including material slot order (white=0, red=1, green=2, light=3, mirror=4,
dielectric=5) — but drive everything through the declarative SceneBuilder
instead of hardcoded engine code.  The NEE rect light matches the quad
hardcoded in the reference shader (``raytrace.comp:370-383``): y = -1.5,
x,z in [-1/3, 1/3], area 4/9, normal (0,-1,0).
"""

from __future__ import annotations

import os

from .builder import SceneBuilder
from .types import Camera, Environment, Material

# The Cornell meshes ship with the package; RT_ASSETS points the presets at
# a directory that also holds the larger gallery meshes and textures.
PACKAGE_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")
DEFAULT_ASSETS = os.environ.get("RT_ASSETS", PACKAGE_ASSETS)

WHITE, RED, GREEN, LIGHT, MIRROR, DIELECTRIC = range(6)


def default_materials(b: SceneBuilder) -> None:
    """vk_engine.cpp:689-722."""
    b.add_material(Material(name="white"))
    b.add_material(Material(albedo=(1.0, 0.0, 0.0), name="red"))
    b.add_material(Material(albedo=(0.0, 1.0, 0.0), name="green"))
    b.add_material(
        Material(
            albedo=(0.0, 0.0, 0.0),
            emission_color=(1.0, 1.0, 1.0),
            emission_strength=2.4,
            name="light",
        )
    )
    b.add_material(Material(reflectance=1.0, name="mirror"))
    b.add_material(Material(ior=2.0, name="dielectric"))


def cornell_box(b: SceneBuilder, assets: str = DEFAULT_ASSETS) -> None:
    """The 6 walls + area light (vk_engine.cpp:638-678), with the NEE table
    entry for the shader's hardcoded light quad."""
    b.add_obj(
        os.path.join(assets, "light2.obj"),
        material=LIGHT,
        position=(0.0, -1.5, 0.0),
        front_only=True,
        name="light",
    )
    b.add_obj(
        os.path.join(assets, "plane.obj"),
        material=WHITE,
        position=(0.0, 0.5, 0.0),
        front_only=True,
        name="bottom",
    )
    b.add_obj(
        os.path.join(assets, "plane.obj"),
        material=GREEN,
        position=(-1.0, -0.5, 0.0),
        rotation_deg=(90.0, 0.0, 90.0),
        front_only=True,
        name="left",
    )
    b.add_obj(
        os.path.join(assets, "plane.obj"),
        material=RED,
        position=(1.0, -0.5, 0.0),
        rotation_deg=(90.0, 0.0, -90.0),
        front_only=True,
        name="right",
    )
    b.add_obj(
        os.path.join(assets, "ceiling.obj"),
        material=WHITE,
        position=(0.0, -1.5, 0.0),
        front_only=True,
        name="top",
    )
    b.add_obj(
        os.path.join(assets, "plane.obj"),
        material=WHITE,
        position=(0.0, -0.5, 1.0),
        rotation_deg=(90.0, 0.0, 0.0),
        front_only=True,
        name="back",
    )
    b.add_obj(
        os.path.join(assets, "plane.obj"),
        material=WHITE,
        position=(0.0, -0.5, -1.0),
        rotation_deg=(-90.0, 0.0, 0.0),
        front_only=True,
        name="front",
    )
    # NEE light table entry == the shader's hardcoded quad
    # (raytrace.comp:370-383): corner (-1/3,-1.5,-1/3), edges 2/3, area 4/9.
    b.add_rect_light(
        corner=(-1.0 / 3.0, -1.5, -1.0 / 3.0),
        edge_u=(2.0 / 3.0, 0.0, 0.0),
        edge_v=(0.0, 0.0, 2.0 / 3.0),
        normal=(0.0, -1.0, 0.0),
        material=LIGHT,
    )


def default_scene(assets: str = DEFAULT_ASSETS) -> SceneBuilder:
    """The reference's boot scene: Cornell box + two rotated cubes
    (vk_engine.cpp:731-751)."""
    b = SceneBuilder()
    default_materials(b)
    b.add_obj(
        os.path.join(assets, "cube.obj"),
        material=WHITE,
        position=(-0.4, 0.25, -0.45),
        rotation_deg=(0.0, -30.0, 0.0),
        scale=0.25,
        sampler=1,
        name="cube",
    )
    b.add_obj(
        os.path.join(assets, "cube.obj"),
        material=WHITE,
        position=(0.4, -0.2, 0.45),
        rotation_deg=(0.0, 30.0, 0.0),
        scale=(0.3, 0.7, 0.3),
        sampler=1,
        name="cube2",
    )
    cornell_box(b, assets)
    b.set_camera(Camera())
    return b


def cornell_spheres(assets: str = DEFAULT_ASSETS) -> SceneBuilder:
    """BASELINE config 2: Cornell box with mirror + dielectric spheres
    (the commented-out sphere slots at vk_engine.cpp:684-685, materials 5/2)."""
    b = SceneBuilder()
    default_materials(b)
    cornell_box(b, assets)
    b.add_sphere((0.0, 0.1, -0.3), 0.4, DIELECTRIC)
    b.add_sphere((0.5, 0.1, 0.0), 0.4, MIRROR)
    b.set_camera(Camera())
    return b


def sphere_diffuse() -> SceneBuilder:
    """BASELINE config 1: single diffuse sphere over a ground sphere, sky on
    (cf. renders/sphere_diffuse.png). Pure brute-force path — no meshes."""
    b = SceneBuilder()
    default_materials(b)
    b.add_sphere((0.0, -0.5, 0.0), 0.5, WHITE)
    b.add_sphere((0.0, 100.0, 0.0), 100.0, WHITE)  # ground
    b.set_environment(Environment(enabled=True))
    b.set_camera(Camera(position=(0.0, -0.6, -3.0), angles_deg=(0.0, 0.0, 0.0)))
    return b


def cornell_rainbow(assets: str = DEFAULT_ASSETS) -> SceneBuilder:
    """Reconstruction of renders/cornell_rainbow.png: green/blue/red walls
    around a white sphere.  The reference image is an interactive-session
    screenshot, so wall assignment (green left, blue back, red right) and
    the sphere's size/placement are read off the image; everything else is
    the stock Cornell setup (vk_engine.cpp:638-678)."""
    b = SceneBuilder()
    default_materials(b)
    blue = b.add_material(Material(albedo=(0.0, 0.0, 1.0), name="blue"))
    # resting on the floor (y-down world: floor plane at y=+0.5)
    b.add_sphere((0.0, 0.11, 0.0), 0.39, WHITE)
    cornell_box(b, assets)
    # repaint the back wall blue (cornell_box made it white)
    for _, inst in b.instances:
        if inst.name == "back":
            inst.material = blue
    b.set_camera(Camera())
    return b


def spheres_demo() -> SceneBuilder:
    """Reconstruction of renders/sphere_diffuse.png: green/white/red diffuse
    spheres resting on a planet-sized blue-violet ground sphere under the
    sky env light.  Proportions read off the screenshot; the material
    palette extends the stock one."""
    b = SceneBuilder()
    default_materials(b)
    green = b.add_material(Material(albedo=(0.2, 0.55, 0.25), name="dgreen"))
    red = b.add_material(Material(albedo=(0.75, 0.1, 0.1), name="dred"))
    pale = b.add_material(Material(albedo=(0.85, 0.92, 1.0), name="pale"))
    ground = b.add_material(Material(albedo=(0.72, 0.72, 0.95), name="ground"))
    # planet top is at y=0.2 (y-down world); resting centers sit at 0.2 - r
    b.add_sphere((-0.95, -0.55, 0.5), 0.75, green)
    b.add_sphere((0.1, -0.25, 0.6), 0.45, pale)
    b.add_sphere((1.0, -0.08, 0.5), 0.28, red)
    b.add_sphere((0.0, 100.2, 0.0), 100.0, ground)
    b.set_environment(Environment(enabled=True))
    b.set_camera(
        Camera(position=(0.0, -0.8, -3.8), angles_deg=(0.0, 0.0, 0.0))
    )
    return b


def monkey_demo(assets: str = DEFAULT_ASSETS) -> SceneBuilder:
    """Reconstruction of renders/monkey_dielectric.png: a blue-glass Suzanne
    next to a blue-glass sphere in the white-walled Cornell box.  Material
    and placement read off the screenshot (dielectric tint = albedo, like
    the reference's dielectricBTDF radiance)."""
    b = SceneBuilder()
    default_materials(b)
    blueglass = b.add_material(
        Material(albedo=(0.25, 0.25, 1.0), ior=2.0, name="blueglass")
    )
    # floor plane is at y=+0.5 (y-down); both rest on it
    b.add_sphere((-0.5, 0.05, 0.1), 0.45, blueglass)
    b.add_obj(
        os.path.join(assets, "monkey.obj"),
        material=blueglass,
        position=(0.45, 0.008, 0.0),
        rotation_deg=(0.0, 180.0, 0.0),  # face the camera
        scale=0.5,
        sampler=1,
        name="monkey",
    )
    cornell_box(b, assets)
    b.set_camera(Camera())
    return b


def dread_demo(assets: str = DEFAULT_ASSETS, kind: str = "texture") -> SceneBuilder:
    """Reconstruction of the dread gallery family — renders/dread_texture.png
    (``kind="texture"``), dread_white.png (``"white"``), dread_metallic.png
    (``"metallic"``: the reflectance-flag chrome of the snapshot's untinted
    specularBRDF, raytrace.comp:466-469) and dread_texture_metallic.png
    (``"texture_metallic"``: albedo map + reflectance, rendered with
    ``tint_spec_diel`` so the mirror lobe carries the sampled albedo like
    the screenshot's gold panels) — in the Cornell box, seen from the +z
    side (the screenshots' walls are mirrored: red left, green right).
    The shipped dread.mtl has no map_Kd — the texture was assigned in the
    reference's interactive session — so the builder's add_texture API
    recreates the assignment (BASELINE config 4's texture capability)."""
    b = SceneBuilder()
    default_materials(b)
    b.add_obj(
        os.path.join(assets, "dread.obj"),
        material=WHITE,
        position=(-0.66, 0.38, 0.0),
        scale=1.5,
        sampler=1,
        name="dread",
    )
    cornell_box(b, assets)
    if kind == "white":
        m = WHITE
    elif kind == "metallic":
        m = b.add_material(Material(reflectance=1.0, name="chrome"))
    else:
        tex = b.add_texture(os.path.join(assets, "dread_alb.png"))
        m = b.add_material(
            Material(
                albedo=(1.0, 1.0, 1.0),
                albedo_tex=tex,
                reflectance=1.0 if kind == "texture_metallic" else 0.0,
                name="dread",
            )
        )
    for _, inst in b.instances:
        if inst.name == "dread":
            inst.material = m
    b.set_camera(
        Camera(position=(0.0, -0.5, 3.5), angles_deg=(4.0, 180.0, 0.0))
    )
    return b


def mtlmap_demo(
    model: str, metalness: bool = True, assets: str = DEFAULT_ASSETS,
    scale: float = 0.6, rotation_deg=(0.0, 0.0, 0.0), position=None,
    solid: Material | None = None, camera: Camera | None = None,
) -> SceneBuilder:
    """Reconstruction of the textured-weapon gallery renders
    (renders/rb_mtlmap.png, squeezer_mtlmap.png, slosher_cornell.png):
    ``{model}.obj`` lying on the Cornell floor with its albedo map
    ``{model}_alb.png`` and (for the mtlmap shots) its metalness map
    ``{model}_mtl.png`` driving the reflectance lobe.  The shipped objs
    carry no .mtl — the maps were assigned interactively in the reference
    session (like dread_demo), recreated here via add_texture.  Exercises
    the map_Ks metalness plumbing of src/vk_engine.cpp:1118-1124."""
    b = SceneBuilder()
    default_materials(b)
    # rest the model on the floor (y-down, floor at +0.5): the meshes span
    # roughly y in [-0.6, 0.25] and x in [-0.6, 1.2] (muzzle along +x)
    bounds = {
        "rb": (0.19, 0.28), "squeezer": (0.15, 0.51), "slosher": (0.24, 0.34)
    }
    ymax, xc = bounds.get(model, (0.2, 0.3))
    if position is None:
        position = (-scale * xc, 0.5 - scale * ymax, 0.0)
    b.add_obj(
        os.path.join(assets, f"{model}.obj"),
        material=WHITE,
        position=position,
        rotation_deg=rotation_deg,
        scale=scale,
        sampler=1,
        name=model,
    )
    cornell_box(b, assets)
    if solid is not None:
        # solid-material gallery variants (rb_gold.png, rb_dielectric.png):
        # the same interactive session with a plain material assigned
        # instead of the maps
        m = b.add_material(solid)
    else:
        alb = b.add_texture(os.path.join(assets, f"{model}_alb.png"))
        mtl = (
            b.add_texture(os.path.join(assets, f"{model}_mtl.png"))
            if metalness
            else -1
        )
        m = b.add_material(
            Material(albedo=(1.0, 1.0, 1.0), albedo_tex=alb,
                     metalness_tex=mtl, name=model)
        )
    for _, inst in b.instances:
        if inst.name == model:
            inst.material = m
    # same +z viewpoint as dread_texture.png: the screenshots show red on
    # the LEFT, i.e. the mirrored-wall side of the default pose
    b.set_camera(
        camera
        or Camera(position=(0.0, -0.5, 3.5), angles_deg=(4.0, 180.0, 0.0))
    )
    return b


def mesh_scene(
    obj_name: str,
    material: int = DIELECTRIC,
    scale=0.7,
    position=(0.0, 0.53, 0.0),
    rotation_deg=(0.0, 0.0, 0.0),
    assets: str = DEFAULT_ASSETS,
) -> SceneBuilder:
    """BASELINE configs 3/4: a mesh (bunny/dread/...) inside the Cornell box
    (cf. vk_engine.cpp:745-749)."""
    b = SceneBuilder()
    default_materials(b)
    b.add_obj(
        os.path.join(assets, obj_name),
        material=material,
        position=position,
        rotation_deg=rotation_deg,
        scale=scale,
        sampler=1,
        name=obj_name,
    )
    cornell_box(b, assets)
    b.set_camera(Camera())
    return b


def unlit_sphere() -> SceneBuilder:
    """renders/unlit_sphere.png: the earliest gallery shot — one emissive
    white sphere on black (environment off, no lights, no walls).  The
    sphere reads uniformly white because emission is credited directly at
    the primary hit (raytrace.comp:500-505, the ``j == 0`` emission add)."""
    b = SceneBuilder()
    default_materials(b)
    glow = b.add_material(
        Material(
            albedo=(0.0, 0.0, 0.0),
            emission_color=(1.0, 1.0, 1.0),
            emission_strength=1.0,
            name="glow",
        )
    )
    b.add_sphere((0.0, 0.0, 0.0), 0.9, glow)
    b.set_camera(Camera(position=(0.0, 0.0, -3.5), angles_deg=(0.0, 0.0, 0.0)))
    return b


def dielectrics(assets: str = DEFAULT_ASSETS) -> SceneBuilder:
    """renders/dielectrics.png: a clear glass sphere beside the stock red
    diffuse sphere in the Cornell box at the default (boot) pose — green
    wall left, red wall right.  Sphere sizes/placement read off the
    screenshot; both rest on the floor plane at y=+0.5 (y-down world)."""
    b = SceneBuilder()
    default_materials(b)
    b.add_sphere((-0.35, 0.21, -0.1), 0.29, DIELECTRIC)
    b.add_sphere((0.38, 0.16, 0.15), 0.34, RED)
    cornell_box(b, assets)
    b.set_camera(Camera())
    return b


def sphere_reflectance() -> SceneBuilder:
    """renders/sphere_reflectance.png: the planet scene with the middle
    sphere swapped for a floating gold mirror.  The screenshot's ImGui
    panel RECORDS the material — albedo (221,165,8)/255, reflectance 0.85
    — making this the one gallery case with pinned material values.  The
    gold-tinted reflection is the pre-snapshot tinted specular lobe
    (render with ``RenderConfig.tint_spec_diel``; the snapshot's
    specularBRDF returns untinted vec3(1), raytrace.comp:466-469)."""
    b = spheres_demo()
    gold = b.add_material(
        Material(
            albedo=(221 / 255.0, 165 / 255.0, 8 / 255.0),
            reflectance=0.85,
            name="gold",
        )
    )
    s = b.spheres[1]  # the middle 'pale' sphere
    s.position = (0.3, -1.45, 0.9)  # floating (y-down: negative y is up)
    s.radius = 0.62
    s.material = gold
    return b


def _single_tri_obj(v0, v1, v2) -> str:
    """Write a one-triangle OBJ to a temp file (the reference's standalone
    test triangle was hardcoded engine-side; no equivalent asset ships)."""
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".obj", prefix="rt_tri_")
    with os.fdopen(fd, "w") as f:
        for v in (v0, v1, v2):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        f.write("f 1 2 3\n")
    return path


def triangle_reflectance() -> SceneBuilder:
    """renders/triangle_reflectance.png: the planet scene with a glossy
    white middle sphere, a violet test triangle floating behind it, and a
    mirror-tinted planet surface (the screenshot shows sharp reflections
    of all three spheres in the blue ground).  Tinted speculars are the
    pre-snapshot lobe — render with ``tint_spec_diel``."""
    b = spheres_demo()
    gloss = b.add_material(
        Material(albedo=(0.85, 0.92, 1.0), reflectance=0.8, name="gloss")
    )
    b.spheres[1].material = gloss
    mirror_ground = b.add_material(
        Material(albedo=(0.72, 0.72, 0.95), reflectance=0.5, name="mirrorg")
    )
    b.spheres[3].material = mirror_ground  # the planet
    violet = b.add_material(
        Material(albedo=(0.5, 0.5, 0.85), name="violet")
    )
    # apex-down triangle behind the middle sphere (screen-up = -y)
    tri = _single_tri_obj(
        (-0.5, -1.75, 1.2), (0.6, -1.75, 1.2), (0.05, -0.65, 1.2)
    )
    b.add_obj(tri, material=violet, name="triangle")
    return b


def obj_normals_demo(assets: str = DEFAULT_ASSETS) -> SceneBuilder:
    """renders/obj_normals.png: the textured rb weapon floating over a
    bright-green planet — the smooth-vertex-normal milestone shot.  This
    is the ONE gallery screenshot whose ImGui panel records the full
    camera state: fov 50, rotation (4, -89, 0), position (-3, -0.5, -1),
    rays-per-pixel 1, bounce limit 1 — so the reconstruction pins the
    camera instead of guessing it (render with ``bounce_limit=1``)."""
    b = SceneBuilder()
    default_materials(b)
    grass = b.add_material(Material(albedo=(0.35, 0.85, 0.2), name="grass"))
    # Planet limb fitted to the screenshot (r5): 14 limb rays measured in
    # the 2x top-anchored viewport (window 1728x1117, vk_engine.h:338),
    # sphere tangency least-squares at the pinned camera; radius is
    # scale-degenerate along the tangent cone, r=4 chosen mid-range
    # (max limb residual 0.0007 world units).
    b.add_sphere((-2.869, 3.624, 0.042), 4.0, grass)
    alb = b.add_texture(os.path.join(assets, "rb_alb.png"))
    m = b.add_material(
        Material(albedo=(1.0, 1.0, 1.0), albedo_tex=alb, name="rb")
    )
    # camera looks along +x (yaw -89); screen-left is +z, so point the
    # muzzle (+x in model space) toward +z
    b.add_obj(
        os.path.join(assets, "rb.obj"),
        material=m,
        position=(0.0, -0.15, 0.35),
        rotation_deg=(0.0, 90.0, 0.0),
        scale=0.9,
        sampler=1,
        name="rb",
    )
    b.set_environment(Environment(enabled=True))
    b.set_camera(
        Camera(position=(-3.0, -0.5, -1.0), angles_deg=(4.0, -89.0, 0.0))
    )
    return b


def obj_reflectance_demo(assets: str = DEFAULT_ASSETS) -> SceneBuilder:
    """renders/obj_reflectance.png: the planet scene with a bronze-mirror
    rb weapon lying across the spheres and the violet test quad floating
    top-right.  The weapon's tan reflections are the pre-snapshot tinted
    specular — render with ``tint_spec_diel``."""
    b = spheres_demo()
    bronze = b.add_material(
        Material(albedo=(0.85, 0.65, 0.5), reflectance=1.0, name="bronze")
    )
    b.add_obj(
        os.path.join(assets, "rb.obj"),
        material=bronze,
        position=(0.1, -0.3, 0.35),
        rotation_deg=(0.0, 180.0, 0.0),
        scale=1.1,
        sampler=1,
        name="rb",
    )
    violet = b.add_material(Material(albedo=(0.5, 0.5, 0.85), name="violet"))
    import tempfile

    fd, quad = tempfile.mkstemp(suffix=".obj", prefix="rt_quad_")
    with os.fdopen(fd, "w") as f:
        # camera-facing square, half-extent 0.42
        for v in (
            (-0.42, -0.42, 0.0), (0.42, -0.42, 0.0),
            (0.42, 0.42, 0.0), (-0.42, 0.42, 0.0),
        ):
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        f.write("f 1 2 3\nf 1 3 4\n")
    b.add_obj(quad, material=violet, position=(0.35, -1.4, 1.6), name="quad")
    return b


def rb_metallic_demo(assets: str = DEFAULT_ASSETS) -> SceneBuilder:
    """renders/rb_metallic.png: the planet scene with the TEXTURED rb
    (albedo map) given the reflectance flag — a textured mirror whose
    reflections carry the sampled albedo (tinted pre-snapshot specular;
    render with ``tint_spec_diel``)."""
    b = spheres_demo()
    alb = b.add_texture(os.path.join(assets, "rb_alb.png"))
    m = b.add_material(
        Material(albedo=(1.0, 1.0, 1.0), albedo_tex=alb, reflectance=1.0,
                 name="rbmet")
    )
    b.add_obj(
        os.path.join(assets, "rb.obj"),
        material=m,
        position=(0.1, -0.3, 0.35),
        rotation_deg=(0.0, 180.0, 0.0),
        scale=1.1,
        sampler=1,
        name="rb",
    )
    return b


def bobadog_demo(assets: str = DEFAULT_ASSETS) -> SceneBuilder:
    """README-featured eggplant-dog model (reference README.md:22-23 links
    renders/bobadog.png, which is absent from the repo — so no parity row
    is definable).  The point of this preset is the fully AUTOMATIC
    OBJ->MTL->texture pipeline on a shipped asset: bobadog.mtl assigns
    bobaxture2.png via ``map_Ka`` (mtlio routes map_Ka/map_Kd to the
    albedo slot, vk_engine.cpp:1109-1141) and every usemtl group resolves
    its own MTL material — no manual add_texture/material assignment,
    unlike the weapon gallery whose objs ship without MTLs.  Staged in the
    Cornell box at the +z gallery viewpoint, feet on the floor plane
    (y-down: position_y = 0.5 - scale*mesh_max_y)."""
    b = SceneBuilder()
    default_materials(b)
    b.add_obj(
        os.path.join(assets, "bobadog", "bobadog.obj"),
        position=(-0.5, 0.835, 0.16),
        rotation_deg=(0.0, 160.0, 0.0),
        scale=0.5,
        sampler=1,
        name="bobadog",
    )
    cornell_box(b, assets)
    b.set_camera(
        Camera(position=(0.0, -0.5, 3.5), angles_deg=(4.0, 180.0, 0.0))
    )
    return b


def sponza_proxy(n_tris_target: int = 260_000, seed: int = 7) -> SceneBuilder:
    """Sponza-scale procedural stand-in (BASELINE config 5).

    The reference tree ships sponza.mtl + textures but no sponza .obj (load
    commented out, vk_engine.cpp:729 -- SURVEY S6 caveat) and the sandbox
    has no network egress (fetch attempt documented in PARITY.md), so scale
    testing uses a generated two-story atrium patterned on the real Crytek
    layout: a rectangular courtyard ringed by two tiers of colonnades,
    beams over each row, wavy curtains hanging in the arcade, and foliage
    clutter -- the content mix (curved lathes + long thin beams + rippled
    sheets + irregular soup) that gives the real asset its BVH hardness.
    tools/scene_hardness.py substantiates the match (SAH cost / depth /
    per-ray test counts vs klein and the real asset's 262k-tri anchor).
    Geometry is deterministic in ``seed``.
    """
    import numpy as np

    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    default_materials(b)
    import tempfile

    def write_obj(prefix, verts, faces):
        fd, path = tempfile.mkstemp(suffix=".obj", prefix=prefix)
        with os.fdopen(fd, "w") as f:
            for v in verts:
                f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
            for fa in faces:
                f.write(f"f {fa[0]} {fa[1]} {fa[2]}\n")
        return path

    def make_column(n_seg=44):
        """Fluted lathed column with base/shaft/capital profile — high
        tessellation like the real asset's ornate columns (the real
        Sponza's 262k tris live mostly in per-object detail, not object
        count)."""
        verts, faces = [], []
        prof = [(0.34, 0.0), (0.3, 0.05), (0.26, 0.12), (0.22, 0.2),
                (0.2, 0.3), (0.195, 0.5), (0.19, 0.9), (0.19, 1.3),
                (0.195, 1.55), (0.21, 1.7), (0.24, 1.8), (0.28, 1.88),
                (0.31, 1.95), (0.34, 2.0)]
        n_prof = len(prof)
        for i in range(n_seg):
            a = 2 * np.pi * i / n_seg
            flute = 1.0 + 0.05 * np.cos(10.0 * a)  # fluting ridges
            for r, y in prof:
                rr = r * (flute if 0.25 < y < 1.6 else 1.0)
                verts.append((rr * np.cos(a), -y, rr * np.sin(a)))
        for i in range(n_seg):
            for j in range(n_prof - 1):
                a = i * n_prof + j
                c = ((i + 1) % n_seg) * n_prof + j
                faces.append((a + 1, c + 1, a + 2))
                faces.append((c + 1, c + 2, a + 2))
        return write_obj("rt_column_", verts, faces), len(faces)

    def make_curtain(nx=24, ny=36):
        """Rippled hanging sheet: the Sponza-curtain analogue (thin,
        doubly-curved, large-area leaves -- the classic SAH worst case)."""
        verts, faces = [], []
        for j in range(ny + 1):
            for i in range(nx + 1):
                u, v = i / nx, j / ny
                x = (u - 0.5) * 1.6
                y = -v * 2.2
                z = 0.22 * np.sin(u * 6.0) * (0.3 + 0.7 * v) \
                    + 0.08 * np.sin(v * 9.0)
                verts.append((x, y, z))
        for j in range(ny):
            for i in range(nx):
                a = j * (nx + 1) + i + 1
                bq = a + 1
                c = a + nx + 1
                d = c + 1
                faces.append((a, bq, d))
                faces.append((a, d, c))
        return write_obj("rt_curtain_", verts, faces), len(faces)

    def make_beam(n_seg=32):
        """Lintel over a colonnade row, tessellated along its length —
        real Sponza has no courtyard-spanning triangles, and monster
        AABBs would put the beam in every ray's leaf visits."""
        verts, faces = [], []
        ys = (0.0, -0.22)
        zs = (-0.14, 0.14)
        for i in range(n_seg + 1):
            x = -0.5 + i / n_seg
            for y in ys:
                for z in zs:
                    verts.append((x, y, z))
        # 4 side strips along the length (skip tiny end caps)
        side_pairs = [(0, 1), (1, 3), (3, 2), (2, 0)]  # corner ring order
        corner = {0: (0, 0), 1: (0, 1), 3: (1, 1), 2: (1, 0)}  # (yi, zi)
        for i in range(n_seg):
            a0 = i * 4
            b0 = (i + 1) * 4
            for c0, c1 in side_pairs:
                y0, z0 = corner[c0]
                y1, z1 = corner[c1]
                p = a0 + 2 * y0 + z0 + 1
                q = a0 + 2 * y1 + z1 + 1
                r = b0 + 2 * y1 + z1 + 1
                s = b0 + 2 * y0 + z0 + 1
                faces.append((p, q, r))
                faces.append((p, r, s))
        return write_obj("rt_beam_", verts, faces), len(faces)

    def make_floor(nx=24, nz=48):
        """Tessellated courtyard floor slab (the reference's plane.obj is
        one quad; a 16x44-unit triangle pair is not Sponza-like)."""
        verts, faces = [], []
        for j in range(nz + 1):
            for i in range(nx + 1):
                verts.append(((i / nx - 0.5) * 2.0, 0.0,
                              (j / nz - 0.5) * 2.0))
        for j in range(nz):
            for i in range(nx):
                a = j * (nx + 1) + i + 1
                bq = a + 1
                c = a + nx + 1
                d = c + 1
                faces.append((a, bq, d))
                faces.append((a, d, c))
        return write_obj("rt_floor_", verts, faces), len(faces)

    def make_foliage(n=480):
        """Irregular triangle soup in a ball (potted-plant analogue)."""
        verts, faces = [], []
        for k in range(n):
            c = rng.normal(0, 0.28, 3)
            c[1] = -abs(c[1]) * 0.9
            for _ in range(3):
                p = c + rng.normal(0, 0.09, 3)
                verts.append(tuple(p))
            faces.append((3 * k + 1, 3 * k + 2, 3 * k + 3))
        return write_obj("rt_foliage_", verts, faces), len(faces)

    col_path, col_tris = make_column()
    cur_path, cur_tris = make_curtain()
    beam_path, beam_tris = make_beam()
    fol_path, fol_tris = make_foliage()

    # Courtyard: 2:1 rectangle like the real atrium.  Two rows x two
    # tiers x two sides of nz columns each; nz derives from the column
    # triangle budget (~55% of the target).
    nz = max(3, int(n_tris_target * 0.58) // col_tris // 8)
    L, W = nz * 1.35, 6.0  # courtyard half-extents derive from spacing
    k = 0
    for tier in range(2):
        ty = -2.05 * tier
        for row, xoff in ((0, W), (1, W - 1.6)):
            for sx in (-1.0, 1.0):
                for iz in range(nz):
                    z = -L + (2 * L) * (iz + 0.5) / nz + rng.uniform(-0.1, 0.1)
                    x = sx * (xoff + rng.uniform(-0.06, 0.06))
                    b.add_obj(
                        col_path,
                        material=int(rng.integers(0, 3)),
                        position=(x, ty, z),
                        rotation_deg=(0.0, float(rng.uniform(0, 360)), 0.0),
                        scale=(float(rng.uniform(0.8, 1.05)),
                               float(rng.uniform(0.95, 1.05)),
                               float(rng.uniform(0.8, 1.05))),
                        name=f"col{k}",
                    )
                    k += 1

    # beams over each colonnade row (long thin tris spanning the courtyard)
    for tier in range(2):
        ty = -2.0 - 2.05 * tier
        for xoff in (W, W - 1.6):
            for sx in (-1.0, 1.0):
                b.add_obj(
                    beam_path, material=WHITE,
                    position=(sx * xoff, ty, 0.0),
                    rotation_deg=(0.0, 90.0, 0.0),
                    scale=(2.0 * L + 1.0, 1.0, 1.0),
                    name=f"beam{tier}{sx}{xoff:.0f}",
                )

    # curtains hanging from the upper arcade beams
    n_cur = max(2, int(n_tris_target * 0.24) // cur_tris)
    for i in range(n_cur):
        sx = -1.0 if i % 2 else 1.0
        z = -L + (2 * L) * ((i // 2) + 0.5) / max(1, n_cur // 2)
        b.add_obj(
            cur_path,
            material=int(rng.integers(0, 3)),
            position=(sx * (W - 0.8), -3.9, z + rng.uniform(-0.2, 0.2)),
            rotation_deg=(0.0, 90.0 + float(rng.uniform(-10, 10)), 0.0),
            scale=(float(rng.uniform(0.9, 1.3)), float(rng.uniform(0.9, 1.1)),
                   1.0),
            name=f"curtain{i}",
        )

    # foliage pots along the lower arcade
    n_fol = max(2, int(n_tris_target * 0.22) // fol_tris)
    for i in range(n_fol):
        sx = -1.0 if i % 2 else 1.0
        z = -L + (2 * L) * ((i // 2) + 0.5) / max(1, n_fol // 2)
        b.add_obj(
            fol_path,
            material=GREEN,
            position=(sx * (W - 2.6) * rng.uniform(0.2, 1.0), -0.4,
                      z + rng.uniform(-0.5, 0.5)),
            rotation_deg=(0.0, float(rng.uniform(0, 360)), 0.0),
            scale=float(rng.uniform(0.7, 1.2)),
            name=f"foliage{i}",
        )

    # floor + emissive sky strip over the open courtyard
    floor_path, _ = make_floor()
    b.add_obj(
        floor_path,
        material=WHITE,
        position=(0.0, 0.0, 0.0),
        scale=(W + 2.0, 1.0, L + 2.0),
        front_only=True,
        name="floor",
    )
    b.add_obj(
        os.path.join(DEFAULT_ASSETS, "light2.obj"),
        material=LIGHT,
        position=(0.0, -4.6, 0.0),
        scale=(W - 2.0, 1.0, L),
        name="skylight",
    )
    b.add_rect_light(
        corner=(-(W - 2.0) / 3.0, -4.6, -L / 3.0),
        edge_u=(2.0 * (W - 2.0) / 3.0, 0.0, 0.0),
        edge_v=(0.0, 0.0, 2.0 * L / 3.0),
        normal=(0.0, -1.0, 0.0),
        material=LIGHT,
    )
    # open-air courtyard: sky contributes through the roof opening like
    # the real atrium
    b.set_environment(Environment(enabled=True))
    # classic down-the-arcade shot: camera between the colonnade rows so
    # columns, curtains and beams fill the frustum
    b.set_camera(
        Camera(position=(3.8, -1.7, -L * 0.85), angles_deg=(2.0, -14.0, 0.0))
    )
    return b
