from wave_tracer_tpu_torch.scene.model import (IntegratorConfig, Scene,  # noqa: F401
                                               Shape)
from wave_tracer_tpu_torch.scene.build import (BuiltScene,  # noqa: F401
                                               build_scene)
from wave_tracer_tpu_torch.scene.bridge import (SceneData,  # noqa: F401
                                                scene_data_from_numpy)
