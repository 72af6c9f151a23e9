"""wave_tracer_tpu_torch — the PyTorch/CUDA port of wave_tracer_tpu.

The package mirrors the JAX package's directories and module names, so each
module's twin is easy to find (``wave_tracer_tpu/<dir>/<mod>.py`` ↔
``wave_tracer_tpu_torch/<dir>/<mod>.py``). It imports torch and numpy only,
never jax, flax or wave_tracer_tpu, so it runs on GPU hosts without JAX.

Layers:
  * host scene model and bake (numpy): core, geometry, spectrum, texture,
    bsdf.model, emitter.model, scene.{model,build,procedural}
  * device tables (torch tensors): scene.bridge.scene_data_from_numpy is
    the single door from a dict of numpy arrays to SceneData
  * device math (plain torch): sampling, math, polarization, bsdf.device,
    emitter.table, scene.spectral, sensor, ops, wave, accel.edges,
    integrator (the classical and the wave bounce, the lane pool)
  * hand-written CUDA kernels, built by accel.nvcc_build:
    csrc/ray_kernels.cu (closest hit and any hit), wrapped by
    accel.ray_kernels, and csrc/cone_kernels.cu (the cone-triangle
    boundary sweep), wrapped by accel.cone_kernels; on CPU tensors the
    wrappers run their plain torch versions
  * scene files and output (standard library and numpy): scene.xml,
    geometry.{obj,ply}, render.{output,checkpoint,mask}, util.{stats,tev}

Entry points: ``python -m wave_tracer_tpu_torch render scene.xml`` (cli),
and ``render.render_scene(scene.build_scene(scene), device=...)``.
"""

__version__ = "0.1.0"
