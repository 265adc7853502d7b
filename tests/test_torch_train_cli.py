"""The port's training command line (``train``) and its logging
(``metrics``), on the CPU.

- The parser has the JAX trainer's option strings, types, choices, actions
  and defaults, read from JAX's ``train.py`` source with ``ast`` (JAX's
  ``main`` is not called: its first lines point JAX's compilation cache at
  the repository's ``.jax_cache``), plus ``--device``.
- ``metrics.env_metrics`` agrees with JAX's on a converted state;
  ``JsonlLogger`` writes JAX's row keys; ``profile_trace`` writes a Chrome
  trace and is a no-op on None.
- ``main`` trains two updates at a tiny shape (the env at 4/2 solver
  iterations and an 8-step time limit, as ``test_torch_evaluate.py`` runs
  ``evaluate.main``), evaluates at update 2, checkpoints every update,
  writes finite JSONL rows that ``scripts/curve.py`` prints as an eval row;
  a ``--resume`` run continues at update 2.
- JAX's checks on the multi-process flags: ``--coordinator`` under
  ``--distributed`` needs ``--num-processes`` and ``--process-id``, and
  ``--distributed`` alone needs torchrun's variables (JAX's auto-detection);
  tests/test_torch_multiprocess.py trains on two ranks.
"""

import ast
import json
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_car_racing_tpu import metrics as jmetrics

from multi_car_racing_tpu_torch import EnvConfig, convert, env as penv, metrics, train
from multi_car_racing_tpu_torch.parallel import mesh
from test_torch_obs import jax_state
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_options():
    """{option string: {"type", "default", "action", "choices"}} of the
    ``ap.add_argument`` calls in the JAX ``train.py``."""
    tree = ast.parse(open(os.path.join(ROOT, "multi_car_racing_tpu", "train.py")).read())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: k.value for k in node.keywords}
            spec = {"type": kw["type"].id if "type" in kw else None,
                    "default": ast.literal_eval(kw["default"]) if "default" in kw else None,
                    "action": ast.literal_eval(kw["action"]) if "action" in kw else None,
                    "choices": ast.literal_eval(kw["choices"]) if "choices" in kw else None}
            out[ast.literal_eval(node.args[0])] = spec
    return out


def test_parser_has_jax_options_and_defaults():
    want = _jax_options()
    assert len(want) == 36
    got = {}
    for act in train.build_parser()._actions:
        if not act.option_strings or act.option_strings == ["-h", "--help"]:
            continue
        (opt,) = act.option_strings
        kind = type(act).__name__
        got[opt] = {"type": act.type.__name__ if act.type else None,
                    "default": act.default if kind != "_StoreTrueAction" else None,
                    "action": "store_true" if kind == "_StoreTrueAction" else None,
                    "choices": act.choices}
    assert set(got) == set(want) | {"--device"}
    for opt, spec in want.items():
        assert got[opt] == spec, opt
    assert got["--device"]["default"] is None


def test_env_metrics_match_jax():
    cfg = EnvConfig(num_agents=2, velocity_iters=8, position_iters=3)
    st = penv.reset_batch(cfg, (0, 1, 2), 3, device="cpu")
    for t in range(3):
        st, _, _ = penv.step(cfg, st, torch.tensor([[[0.3, 1.0, 0.0], [-0.2, 0.5, 0.1]]] * 3))
    got = metrics.env_metrics(st)
    want = jmetrics.env_metrics(jax_state(convert.env_state_to_numpy(st)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape == () and got[k].device == st.t.device, k
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6, abs=1e-6), k
    assert float(got["mean_speed"]) > 0.0


def test_jsonl_logger_rows_have_jax_keys(tmp_path):
    rows = []
    for mod, name in ((metrics, "port"), (jmetrics, "jax")):
        path = str(tmp_path / f"{name}.jsonl")
        lg = mod.JsonlLogger(path)
        lg.log(100, {"a": 1.5})
        back = lg.log(200, {"a": torch.tensor(2.5) if mod is metrics else jnp.asarray(2.5)},
                      note="x")
        rows.append([json.loads(line) for line in open(path)])
        assert back == rows[-1][-1]
    port, jax_rows = rows
    assert [r.keys() for r in port] == [r.keys() for r in jax_rows]
    assert port[0]["a"] == 1.5 and port[1]["env_steps"] == 200 and port[1]["note"] == "x"
    assert "env_steps_per_sec" in port[1]


def test_profile_trace(tmp_path):
    with metrics.profile_trace(None):
        torch.ones(3).add_(1)
    with metrics.profile_trace(str(tmp_path / "prof")):
        torch.ones(3).add_(1)
    trace = json.load(open(tmp_path / "prof" / metrics.TRACE_FILE))
    assert trace["traceEvents"]


def _short_episodes(monkeypatch):
    """main's env configs at 4/2 solver iterations and an 8-step time limit."""
    def short(**kw):
        return EnvConfig(**kw, velocity_iters=4, position_iters=2, max_episode_steps=8)

    monkeypatch.setattr(train, "C", SimpleNamespace(EnvConfig=short))


TINY = ["--carracing-v0", "--num-envs", "2", "--rollout", "4", "--pool-size", "2",
        "--width", "32", "--normalize-obs", "--device", "cpu"]


def _rows(path):
    return [json.loads(line) for line in open(path)]


def test_main_trains_evaluates_checkpoints_and_resumes(tmp_path, monkeypatch, capsys):
    _short_episodes(monkeypatch)
    log, ck = str(tmp_path / "run.jsonl"), str(tmp_path / "ck")
    ts = train.main(TINY + ["--updates", "2", "--eval-every", "2", "--eval-episodes", "2",
                            "--log", log, "--checkpoint", ck, "--ckpt-every", "1"])
    out = capsys.readouterr().out
    assert ts.update_i == 2 and "eval: return" in out and "new best" in out
    rows = _rows(log)
    assert [r["update"] for r in rows] == [1, 2, 2]
    train_row, eval_row = rows[1], rows[2]
    assert "loss" in train_row and "mean_tiles_visited" in train_row and "update_s" in train_row
    assert eval_row["eval_episodes"] == 2 and eval_row["eval_len"] == 7.0   # steps from 1
    for r in rows:
        for k, v in r.items():
            assert isinstance(v, (int, float)) and math.isfinite(v), (k, v)
    assert train_row["env_steps"] == 2 * 4 * 2 * 1
    for path in (ck + ".latest", ck + "_best.latest"):
        assert os.path.exists(path), path
    curve = subprocess.run([sys.executable, os.path.join(ROOT, "scripts", "curve.py"), log],
                           capture_output=True, text=True, timeout=60)
    assert curve.returncode == 0, curve.stderr
    assert "| 2 |" in curve.stdout and "best:" in curve.stdout

    # Resume: one more update from the checkpoint, at update 2.
    ts2 = train.main(TINY + ["--updates", "1", "--resume", ck, "--log", log])
    out = capsys.readouterr().out
    assert f"resumed from {ck} at update 2" in out and ts2.update_i == 3
    assert _rows(log)[-1]["update"] == 3
    with pytest.raises(SystemExit):
        train.main(TINY[:-2] + ["--num-envs", "3", "--resume", ck, "--device", "cpu"])
    assert "differ from the flags" in capsys.readouterr().err


@pytest.mark.parametrize("flags", [
    ["--distributed"],
    ["--distributed", "--coordinator", "127.0.0.1:1234"],
    ["--distributed", "--coordinator", "127.0.0.1:1234", "--num-processes", "2"]])
def test_multi_process_flags_are_refused(flags, capsys, monkeypatch):
    for var in mesh.ENV_VARS:
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(SystemExit):
        train.main(flags + ["--device", "cpu"])
    err = capsys.readouterr().err
    if "--coordinator" in flags:
        assert "--coordinator requires --num-processes and --process-id" in err
    else:
        assert "torchrun's variables" in err and "MASTER_ADDR" in err


def test_flag_checks_match_jax(capsys):
    for flags, msg in ((["--action-repeat", "0"], "--action-repeat"),
                       (["--normalize-obs", "--obs", "pixels"], "--normalize-obs")):
        with pytest.raises(SystemExit):
            train.main(flags + ["--device", "cpu"])
        assert msg in capsys.readouterr().err
    assert np.isclose(train.eval_seed(0, 2) - train.eval_seed(0, 1), 1)
