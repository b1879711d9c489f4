"""The port's package contract: no JAX at import, f32 geometry, goldens."""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import densepoints_tpu_torch
from densepoints_tpu.core import Cameras as JaxCameras
from densepoints_tpu.core import ncc_score as jax_ncc
from densepoints_tpu_torch.core.cameras import (
    Cameras,
    decompose_projection_matrix,
)
from densepoints_tpu_torch.core.scores import ncc_score
from densepoints_tpu_torch.interop import (
    patch_state_from_numpy,
    patch_state_to_numpy,
)
from tests.synthetic import TexturedPlaneScene, random_scene
from tests.torch_port_util import torch_cameras

ROOT = Path(__file__).resolve().parent.parent

P_GOLDEN = np.array(
    [
        [3.53553e2, 3.39645e2, 2.77744e2, -1.44946e6],
        [-1.03528e2, 2.33212e1, 4.59607e2, -6.32525e5],
        [7.07107e-1, -3.53553e-1, 6.12372e-1, -9.18559e2],
    ]
)
A = np.array([[1, 2, 3], [-1, -2, -3], [1, 2, 3]], dtype=np.float32)
B = np.array([[2, 0, 5], [-4, 5, -2], [-1, 0, -3]], dtype=np.float32)


@pytest.mark.parametrize("module", [
    "densepoints_tpu_torch",
    "densepoints_tpu_torch.cli",
    "densepoints_tpu_torch.interop",
])
def test_import_pulls_in_no_jax(module):
    # A subprocess: this test process has already imported jax.
    code = (f"import {module}, sys; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'densepoints_tpu' not in sys.modules")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_tf32_is_off():
    assert densepoints_tpu_torch is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_decomposition_golden():
    K, E, C = decompose_projection_matrix(P_GOLDEN)
    assert abs(K[0, 0] - 468.2) < 0.1
    assert abs(K[1, 1] - 427.2) < 0.1
    assert abs(K[0, 2] - 300) < 0.1
    assert abs(K[1, 2] - 200) < 0.1
    assert abs(K[2, 2] - 1) < 1e-9
    np.testing.assert_allclose(C, [1000, 2000, 1500], atol=0.01)
    scale = np.linalg.norm(P_GOLDEN[2, :3])
    np.testing.assert_allclose((K @ E) * scale, P_GOLDEN, atol=0.5)


def test_ncc_golden_value():
    score = ncc_score(torch.as_tensor(A.reshape(-1)),
                      torch.as_tensor(B.reshape(-1)))
    np.testing.assert_allclose(float(score), 0.1005653, rtol=1e-5)
    np.testing.assert_allclose(
        float(ncc_score(torch.as_tensor(A.reshape(-1)),
                        torch.as_tensor(A.reshape(-1)))), 1.0, rtol=1e-6
    )


def test_ncc_masked_matches_jax(rng):
    a = rng.standard_normal((6, 40)).astype(np.float32) * 30
    b = rng.standard_normal((6, 40)).astype(np.float32) * 30
    mask = rng.uniform(size=(6, 40)) > 0.3
    mask[0] = False  # empty row -> -1
    want = np.asarray(jax_ncc(jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(mask)))
    got = ncc_score(torch.as_tensor(a), torch.as_tensor(b),
                    torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got[0] == -1.0


def test_cameras_match_jax(rng):
    Ps, pts = random_scene(rng, num_views=4, num_points=32)
    jc = JaxCameras.from_projection_matrices(Ps, widths=4000, heights=3000)
    tc = Cameras.from_projection_matrices(Ps, 4000, 3000)
    for f in ("P", "K", "E", "C", "x_axis", "width", "height"):
        np.testing.assert_array_equal(
            getattr(tc, f).numpy(), np.asarray(getattr(jc, f)), err_msg=f
        )
    pts32 = pts.astype(np.float32)
    jpix, jdepth = jc.project_with_depth(jnp.asarray(pts32))
    pix, depth = tc.project_with_depth(torch.as_tensor(pts32))
    np.testing.assert_allclose(pix.numpy(), np.asarray(jpix), rtol=1e-5,
                               atol=1e-3)
    np.testing.assert_allclose(depth.numpy(), np.asarray(jdepth), rtol=1e-5)
    np.testing.assert_array_equal(
        tc.points_inside(torch.as_tensor(pts32)).numpy(),
        np.asarray(jc.points_inside(jnp.asarray(pts32))),
    )


def test_interop_round_trip(rng):
    scene = TexturedPlaneScene(rng, num_views=3, width=64, height=48)
    jc = JaxCameras.from_projection_matrices(scene.P, 64, 48)
    tc = torch_cameras(jc)
    assert tc.width.dtype == torch.int32 and tc.P.dtype == torch.float32
    fields = {
        "position": rng.standard_normal((5, 3)).astype(np.float32),
        "normal": rng.standard_normal((5, 3)).astype(np.float32),
        "ref": rng.integers(0, 3, 5).astype(np.int32),
        "vis": rng.uniform(size=(5, 3)) > 0.5,
        "cand": rng.uniform(size=(5, 3)) > 0.5,
        "alive": rng.uniform(size=5) > 0.5,
        "color": rng.uniform(0, 255, (5, 3)).astype(np.float32),
    }
    out = patch_state_to_numpy(patch_state_from_numpy(**fields))
    for name, value in fields.items():
        np.testing.assert_array_equal(out[name], value, err_msg=name)
        assert out[name].dtype == value.dtype, name
