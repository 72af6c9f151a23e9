from wave_tracer_tpu_torch.render.renderer import Renderer, render_scene  # noqa: F401
