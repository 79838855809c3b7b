"""The port's launcher ``repro_torch.launch.train`` with ``--elastic`` on the
CPU, as subprocesses (reduced smollm-135m, 4 workers on a ring, seq 16,
batch 1; the bigram table goes to pytest's ``tmp_path``):

- a fault-free ``--elastic`` run's history is bitwise the plain launcher's;
- ``tests/test_elastic.py``'s crash test against the port: a run killed by
  SIGKILL (``--kill-at-step``) and continued with ``--resume`` logs the
  uninterrupted run's losses and consensus errors bitwise at every step it
  ran (the history's floats are shortest round-trip reprs, so equal strings
  are equal bits), through a drift re-solve and a churn window;
- without ``--device`` the elastic launcher asks for ``cuda`` and raises
  ``DeviceFault`` where there is no card; ``--resume`` needs ``--ckpt-dir``.
"""
import json
import os
import signal
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch.device import DeviceFault  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--arch", "smollm-135m", "--reduced", "--workers", "4", "--batch", "1", "--seq", "16",
        "--topo", "ring", "--log-every", "1", "--seed", "0", "--device", "cpu"]
ELASTIC = BASE + ["--steps", "10", "--elastic", "--drift-step", "4", "--slow-nodes", "1",
                  "--slow-bw", "1.0", "--churn-events", "1", "--ckpt-every", "3"]
#: the launcher's main() with the bigram table under the test's directory
DRIVER = ("import sys; from pathlib import Path; import repro_torch.data.pipeline as p; "
          "p.TABLE_DIR = Path(sys.argv[1]); from repro_torch.launch.train import main; "
          "main(sys.argv[2:])")


def launch(tmp_path, argv) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"), OMP_NUM_THREADS="2")
    return subprocess.Popen([sys.executable, "-c", DRIVER, str(tmp_path / "bigram")] + argv,
                            env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish(proc, timeout=300):
    out, err = proc.communicate(timeout=timeout)
    return proc.returncode, out + err


def history(path, keys=("loss", "loss_max", "consensus_err")):
    with open(path) as f:
        return {h["step"]: tuple(h[k] for k in keys) for h in json.load(f)["history"]}


def test_fault_free_elastic_launcher_is_bitwise_the_plain_one(tmp_path):
    runs = {name: launch(tmp_path, BASE + ["--steps", "3", "--json-out",
                                           str(tmp_path / f"{name}.json")] + extra)
            for name, extra in (("plain", []), ("elastic", ["--elastic"]))}
    for name, proc in runs.items():
        rc, log = finish(proc)
        assert rc == 0, log
    plain, elastic = history(tmp_path / "plain.json"), history(tmp_path / "elastic.json")
    assert sorted(plain) == [0, 1, 2] and elastic == plain
    with open(tmp_path / "elastic.json") as f:
        out = json.load(f)
    assert out["elastic"]["events"] == [] and out["elastic"]["drops"] == 0
    assert [h["n_alive"] for h in out["history"]] == [4.0] * 3


def test_sigkill_resume_reproduces_the_uninterrupted_curve_bitwise(tmp_path):
    full = launch(tmp_path, ELASTIC + ["--json-out", str(tmp_path / "full.json")])
    killed = launch(tmp_path, ELASTIC + ["--ckpt-dir", str(tmp_path / "ck"),
                                         "--kill-at-step", "8"])
    rc, log = finish(full)
    assert rc == 0, log
    rc, log = finish(killed)
    assert rc == -signal.SIGKILL, log
    assert sorted(os.listdir(tmp_path / "ck")) == ["ckpt_4.npz", "ckpt_7.npz"]
    rc, log = finish(launch(tmp_path, ELASTIC + ["--ckpt-dir", str(tmp_path / "ck"), "--resume",
                                                 "--json-out", str(tmp_path / "resumed.json")]))
    assert rc == 0, log
    assert "resumed from step 7 (elastic state restored)" in log
    ref, got = history(tmp_path / "full.json"), history(tmp_path / "resumed.json")
    assert set(ref) == set(range(10)) and sorted(got) == [7, 8, 9]
    for step, vals in got.items():
        assert vals == ref[step], (step, vals, ref[step])
    with open(tmp_path / "full.json") as f:
        el = json.load(f)["elastic"]
    assert [(e["step"], e["event"]) for e in el["events"]] == \
        [(4, "reopt"), (5, "adopt"), (8, "reopt"), (9, "adopt")]
    assert el["adopted"] == 2 and el["drops"] > 0


def test_elastic_launcher_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    argv = [a for a in ELASTIC if a not in ("--device", "cpu")]
    with pytest.raises(DeviceFault, match="cuda"):
        ttrain.main(argv)


@pytest.mark.parametrize("argv", [["--resume"], ["--elastic", "--sync", "allreduce"]])
def test_launcher_rejects_inconsistent_flags(argv, capsys):
    with pytest.raises(SystemExit):
        ttrain.parse_args(["--arch", "smollm-135m"] + argv)
    assert "--" in capsys.readouterr().err
