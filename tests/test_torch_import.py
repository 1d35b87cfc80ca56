"""The PyTorch port imports torch and never JAX, flax or the JAX package
(`rrt_tpu`)."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = """
import importlib, pkgutil, sys
import rrt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rrt_tpu_torch.__path__,
                                                "rrt_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "rrt_tpu"))
print(len(names), bad)
print(" ".join(names))
assert not bad, bad
assert "torch" in sys.modules
"""

# modules every import check must reach: the lifecycle's tools, Kerr, the
# lane-sharded path, the last three tools and the random streams
MODULES = ("rrt_tpu_torch.cli", "rrt_tpu_torch.kerr_cli",
           "rrt_tpu_torch.physics.kerr", "rrt_tpu_torch.render.kerr_scene",
           "rrt_tpu_torch.render.renderer", "rrt_tpu_torch.utils.serve",
           "rrt_tpu_torch.utils.accel_walk", "rrt_tpu_torch.utils.accel_viz",
           "rrt_tpu_torch.utils.ray_debug",
           "rrt_tpu_torch.parallel.sharding",
           "rrt_tpu_torch.parallel.distributed",
           "rrt_tpu_torch.parallel.worker",
           "rrt_tpu_torch.tools.scaling_bench",
           "rrt_tpu_torch.tools.run_config", "rrt_tpu_torch.tools.kbench",
           "rrt_tpu_torch.utils.prng", "rrt_tpu_torch.ops.threefry")


def test_port_never_imports_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 15, out.stdout
    names = set(out.stdout.splitlines()[1].split())
    assert set(MODULES) <= names, set(MODULES) - names


def test_chip_smoke_never_imports_jax():
    """chip_smoke.py runs on a machine without JAX, and imports nothing of
    the JAX package either."""
    src = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert "import jax" not in src and "from jax" not in src
    env = dict(os.environ, PYTHONPATH=ROOT)
    check = ("import sys, chip_smoke; "
             "assert not [m for m in sys.modules if m.startswith('jax') "
             "or m.split('.')[0] == 'rrt_tpu']")
    out = subprocess.run([sys.executable, "-c", check], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


_NO_JAX_RUN = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise ImportError("blocked: " + name)
        return None
sys.meta_path.insert(0, Block())
from rrt_tpu_torch import cli
from rrt_tpu_torch.scenes import CBOX_SPHERES
r = cli.main(["-f", sys.argv[1], "-r", "8", "8", "-s", "1", "-l", "1",
              "-m", "2", "--device", "cpu", CBOX_SPHERES])
assert r.last_trace_calls == 4, r.last_trace_calls
"""


def test_main_path_runs_where_jax_cannot_be_imported(tmp_path):
    """The whole main path, stats included, on a machine without JAX."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX_RUN, str(tmp_path / "o.png")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "primitive tests" in out.stdout


_IMPORTS_JAX_PACKAGE = re.compile(
    r"^\s*(import\s+rrt_tpu(\s|\.|,|$)|from\s+rrt_tpu(\.|\s))", re.M)


def _port_sources():
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "rrt_tpu_torch")):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return paths


def test_no_port_source_imports_the_jax_package():
    """No line of the port or of chip_smoke.py imports `rrt_tpu`."""
    sources = _port_sources()
    assert len(sources) >= 30
    bad = [(os.path.relpath(p, ROOT), m.group(0).strip())
           for p in sources
           for m in _IMPORTS_JAX_PACKAGE.finditer(open(p).read())]
    assert not bad, bad
    assert _IMPORTS_JAX_PACKAGE.search("from rrt_tpu.io import png")
    assert _IMPORTS_JAX_PACKAGE.search("    import rrt_tpu")
    assert not _IMPORTS_JAX_PACKAGE.search("from rrt_tpu_torch import cli")


_MODULES_AFTER = """
import importlib, pkgutil, sys
import rrt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(rrt_tpu_torch.__path__,
                                                "rrt_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
print(sorted(m for m in sys.modules
             if m == "rrt_tpu" or m.startswith("rrt_tpu.")))
"""


def test_sys_modules_hold_nothing_of_the_jax_package():
    """After every port module and chip_smoke are imported, sys.modules
    holds no module named rrt_tpu or rrt_tpu.*; the host modules the port
    needs are its own (utils.config, utils.stats, io, render.film,
    geometry.clusters, scene.mesh)."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _MODULES_AFTER], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
    for name in ("utils/config.py", "utils/stats.py", "io/png.py",
                 "io/collada.py", "render/film.py", "geometry/clusters.py",
                 "scene/mesh.py"):
        assert os.path.exists(os.path.join(ROOT, "rrt_tpu_torch", name))
