"""ray_tracer_tpu: a JAX (XLA + Pallas) Monte-Carlo path tracer.

Ground-up rebuild of the capabilities of CobaltCrabby/ray_tracer (a Vulkan
compute megakernel path tracer) as a wavefront pipeline of batched kernels.
See SURVEY.md for the reference layer map this package mirrors.
"""

from .api import ProgressiveRenderer, render, render_debug, render_frame, scene_camera
from .config import RenderConfig
from .scene.builder import SceneBuilder
from .scene.types import Camera, CompiledScene, Environment, Material

__version__ = "0.1.0"

__all__ = [
    "ProgressiveRenderer",
    "render",
    "render_debug",
    "render_frame",
    "scene_camera",
    "RenderConfig",
    "SceneBuilder",
    "Camera",
    "CompiledScene",
    "Environment",
    "Material",
]
