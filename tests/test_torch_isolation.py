"""The PyTorch port stands alone: it and chip_smoke.py import neither JAX nor
anything of the JAX package, its entry points refuse to fall back to the CPU
quietly, and chip_smoke.py fails (printing no result) without a card or
without the repository around it."""

import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "multi_car_racing_tpu_torch"
SMOKE = ROOT / "chip_smoke.py"
COMPARE = ROOT / "compare_parent.py"
FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "multi_car_racing_tpu")


def _python(code: str, cwd: Path, timeout: float = 120):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_and_smoke_import_without_jax():
    code = f"""
import importlib.util, sys
for name in ("jax", "jaxlib", "flax"):
    sys.modules[name] = None          # any import of them now raises
sys.path.insert(0, {str(ROOT)!r})
import multi_car_racing_tpu_torch
from multi_car_racing_tpu_torch import config, convert, env, native, obs, seeding, util, _cuda
from multi_car_racing_tpu_torch import demo, gym_api, metrics, monitor, train, tui, window
from multi_car_racing_tpu_torch.oracle import episodes
from multi_car_racing_tpu_torch.parallel import mesh
from multi_car_racing_tpu_torch.physics import (
    collide, fused_world, joints, overlap, shapes, state, tire, track_engine, world)
from multi_car_racing_tpu_torch.track import common, device, host
from multi_car_racing_tpu_torch.render import geometry, particles, pixels, raster
spec = importlib.util.spec_from_file_location("chip_smoke", {str(SMOKE)!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)          # defines main(), does not run it
assert callable(mod.main)
bad = sorted(m for m in sys.modules
             if m == "multi_car_racing_tpu" or m.startswith("multi_car_racing_tpu."))
assert not bad, bad
print("isolated")
"""
    out = _python(code, ROOT)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        list(PORT.rglob("*.py")) + [SMOKE, COMPARE]))
def test_sources_import_nothing_of_jax(path):
    for name in _imports(ROOT / path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN or name.startswith("multi_car_racing_tpu_torch"), \
            f"{path} imports {name}"


def test_entry_points_default_to_cuda():
    from multi_car_racing_tpu_torch import EnvConfig, env, gym_api, train
    from multi_car_racing_tpu_torch.util import resolve_device

    cfg = EnvConfig(num_agents=1, use_random_direction=False)
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        assert gym_api.MultiCarRacing(num_agents=1).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        env.reset_batch(cfg, (0,), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        env.host_reset(cfg, seed=0)
    # The facade and the trainer: no quiet fall back to the CPU either.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gym_api.make("CarRacing-v0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gym_api.MultiCarRacing(num_agents=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--updates", "1", "--num-envs", "2"])
    assert resolve_device("cpu").type == "cpu"
    assert gym_api.make("CarRacing-v0", device="cpu").env.device.type == "cpu"


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py runs there")
    out = subprocess.run([sys.executable, str(SMOKE)], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_outside_the_repository(tmp_path):
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
