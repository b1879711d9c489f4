from densepoints_tpu_torch.io.ply import read_ply, write_mesh_ply, write_ply
from densepoints_tpu_torch.io.scene import (
    Scene,
    SceneSpec,
    load_scene,
    read_scene_json,
)
