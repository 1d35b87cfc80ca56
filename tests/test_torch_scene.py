"""Scene build, converters and camera of the PyTorch port against the JAX
package, on the in-repo Cornell box."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rrt_tpu.io import collada
from rrt_tpu.scene.build import load_scene as jax_load_scene
from rrt_tpu_torch.convert import scene_from_arrays, to_arrays
from rrt_tpu_torch.scene.build import load_scene
from rrt_tpu_torch.scenes import CBOX_SPHERES


def _assert_same_tree(a, b, path=""):
    assert a.keys() == b.keys(), path
    for k in a:
        va, vb = a[k], b[k]
        if isinstance(va, dict):
            _assert_same_tree(va, vb, f"{path}.{k}")
        elif isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and va.shape == vb.shape, f"{path}.{k}"
            np.testing.assert_array_equal(va, vb, err_msg=f"{path}.{k}")
        else:
            assert va == vb, f"{path}.{k}: {va} != {vb}"


def test_collada_file_contents():
    info = collada.load(CBOX_SPHERES)
    assert len(info.nodes) == 9
    assert len(info.find(collada.CameraInfo)) == 1
    lights = info.find(collada.LightInfo)
    assert [n.instance.light_type for n in lights] == ["area"]
    assert len(info.find(collada.SphereInfo)) == 2
    meshes = info.find(collada.PolymeshInfo)
    assert sum(len(n.instance.polygons) for n in meshes) == 16


def test_build_scene_matches_jax_exactly():
    js, _ = jax_load_scene(CBOX_SPHERES, 256, 256)
    ts, _ = load_scene(CBOX_SPHERES, "cpu", 256, 256)
    ja, ta = to_arrays(js), to_arrays(ts)
    assert ja["env"] is ta["env"] is None
    _assert_same_tree(ta, ja)
    assert (ts.n_tris, ts.n_spheres, ts.n_live_spheres) == (64, 8, 2)
    # the default hole at (0, 1, 0) lies inside the box
    lo, hi = ta["cluster_lo"].min(0), ta["cluster_hi"].max(0)
    assert (lo < [0, 1, 0]).all() and ([0, 1, 0] < hi).all()


def test_convert_round_trip():
    ts, _ = load_scene(CBOX_SPHERES, "cpu", 64, 64)
    again = scene_from_arrays(to_arrays(ts), "cpu")
    _assert_same_tree(to_arrays(again), to_arrays(ts))
    assert again.lights.kind_host == ts.lights.kind_host


@pytest.mark.parametrize("size", [(32, 24), (800, 600), (256, 256)])
def test_camera_rays_match_jax(size):
    w, h = size
    _, jcam = jax_load_scene(CBOX_SPHERES, w, h)
    _, tcam = load_scene(CBOX_SPHERES, "cpu", w, h)
    assert (tcam.h_fov, tcam.v_fov, tcam.screen_dist) == \
        (jcam.h_fov, jcam.v_fov, jcam.screen_dist)
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 1, (500, 2)).astype(np.float32)
    jr = jcam.generate_rays(jnp.asarray(xy))
    tr = tcam.generate_rays(torch.tensor(xy))
    np.testing.assert_allclose(tr.o.numpy(), np.asarray(jr.o), atol=1e-6)
    np.testing.assert_allclose(tr.d.numpy(), np.asarray(jr.d), atol=1e-6)
    rr, rt = rng.uniform(0, 1, 500), rng.uniform(0, 2 * np.pi, 500)
    jl = jcam.generate_rays_thin_lens(jnp.asarray(xy), jnp.asarray(rr),
                                      jnp.asarray(rt))
    tl = tcam.generate_rays_thin_lens(torch.tensor(xy),
                                      torch.tensor(rr, dtype=torch.float32),
                                      torch.tensor(rt, dtype=torch.float32))
    np.testing.assert_allclose(tl.o.numpy(), np.asarray(jl.o), atol=1e-6)
    np.testing.assert_allclose(tl.d.numpy(), np.asarray(jl.d), atol=1e-6)


def test_camera_settings_file(tmp_path):
    """The port reads the reference's camera dump that the JAX camera
    writes."""
    _, jcam = jax_load_scene(CBOX_SPHERES, 64, 48)
    path = tmp_path / "cam.txt"
    jcam.dump_settings(str(path))
    _, tcam = load_scene(CBOX_SPHERES, "cpu", 800, 600)
    tcam.load_settings(str(path))
    assert (tcam.h_fov, tcam.screen_w, tcam.screen_h) == \
        (jcam.h_fov, 64, 48)
    np.testing.assert_allclose(tcam.c2w, jcam.c2w)
