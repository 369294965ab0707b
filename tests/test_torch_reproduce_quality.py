"""The port's quality-table tool (``relationalgraphlearning_tpu_torch/tools/
reproduce_quality.py``) against the reference's (``reproduce_quality.py``):
the same table of runs, the commands it issues (the port's CLIs with
``--device`` and the reference's flags in the reference's order), the table
it renders beside the reference's committed records with the gate, and one
real run of one row at toy counts on the CPU through ``cli.train`` and
``cli.test``."""

import importlib.util
import json
import sys
from pathlib import Path

import pytest

from mprl_parity import two_torch_threads  # noqa: F401
from relationalgraphlearning_tpu_torch.tools import reproduce_quality as rq
from test_torch_cli_train import TOY_CONFIG

ROOT = Path(__file__).resolve().parents[1]
PORT = "relationalgraphlearning_tpu_torch"


def _reference():
    """The root ``reproduce_quality.py`` as a module (it imports no JAX
    itself)."""
    spec = importlib.util.spec_from_file_location(
        "reference_reproduce_quality", ROOT / "reproduce_quality.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_runs_are_the_references():
    assert rq.RUNS == _reference().RUNS


def test_commands_name_the_port_and_keep_the_reference_flags(
        tmp_path, monkeypatch):
    """With ``run`` recorded: a trained row's train and test commands, an
    untrained row's test command only, in the table's order, each the
    reference's command with the port's module and ``--device``."""
    ref = _reference()
    calls = []

    def fake_run(cmd, log):
        calls.append(cmd)
        return 0

    monkeypatch.setattr(rq, "run", fake_run)
    ref_calls = []
    monkeypatch.setattr(ref, "run", lambda cmd, log: ref_calls.append(cmd)
                        or 0)
    rq.main(["--only", "cadrl,orca_th10,mprl_band", "--seed", "3",
             "--data_dir", str(tmp_path / "port"), "--device", "cpu"])
    monkeypatch.setattr(sys, "argv", [
        "reproduce_quality.py", "--only", "cadrl,orca_th10,mprl_band",
        "--seed", "3", "--data_dir", str(tmp_path / "ref")])
    ref.main()
    assert len(calls) == len(ref_calls) == 5
    for got, want in zip(calls, ref_calls):
        assert got[:3] == [sys.executable, "-m"] + [
            want[2].replace("relationalgraphlearning_tpu.",
                            f"{PORT}.")]
        assert got[2] in (f"{PORT}.cli.train", f"{PORT}.cli.test")
        train = got[2].endswith("cli.train")
        outdir = got[got.index("--output_dir" if train else "--model_dir")
                     + 1]
        row = {r["name"]: r for r in rq.RUNS}[Path(outdir).name]
        tail = row.get("train_args" if train else "test_args", [])
        extra = ["--device", "cpu"] + ([] if train else ["--out", outdir])
        # the reference's flags with the data directory swapped, the
        # port's own before the row's arguments
        swap = [a.replace(str(tmp_path / "ref"), str(tmp_path / "port"))
                for a in want[3:]]
        head = swap[:len(swap) - len(tail)]
        assert swap[len(head):] == tail
        assert got[3:] == head + extra + tail, (got, want)
    # the row's own arguments come last: argparse keeps the last occurrence
    band = [c for c in calls if "mprl_band" in " ".join(c)][0]
    assert band[-6:] == ["--evaluation_interval", "250", "--randomseed", "3",
                         "--rl_learning_rate", "5e-4"]
    cadrl_test = [c for c in calls if c[2].endswith("cli.test")
                  and "cadrl" in " ".join(c)][0]
    assert cadrl_test[-2:] == ["--human_num", "5"]


def _record(success, collision=0.0, timeout=0.0, nav=11.0):
    return {"success_rate": success, "collision_rate": collision,
            "timeout_rate": timeout, "nav_time": nav, "return": 0.3}


def test_table_renders_port_and_reference_with_the_gate(tmp_path,
                                                        monkeypatch):
    """Fixture records: a pass, a miss, a missing row and a row read from
    the committed fallback."""
    data = tmp_path / "data"
    for name, success in (("sarl", 0.95), ("lstm_rl", 0.85)):
        (data / name).mkdir(parents=True)
        (data / name / "eval_test.json").write_text(json.dumps(
            _record(success, 1 - success)))
    fallback = tmp_path / "committed" / "rgl_s0"
    fallback.mkdir(parents=True)
    (fallback / "eval_test.json").write_text(json.dumps(_record(0.97)))
    monkeypatch.setattr(rq, "COMMITTED_FALLBACK", {"rgl": str(fallback)})
    rq.main(["--table_only", "--only", "sarl,lstm_rl,rgl,cadrl",
             "--data_dir", str(data)])
    rows = json.loads((data / "quality_table.json").read_text())
    text = (data / "quality_table.md").read_text()
    ref = {n: json.loads((ROOT / "results" / n / "eval_test.json")
                         .read_text()) for n in rows}
    assert rows["sarl"]["gate"] == "pass"  # 0.950 against 0.988
    assert rows["lstm_rl"]["gate"] == "miss"  # 0.850 against 0.930
    assert rows["rgl"]["gate"] == "pass"
    assert rows["rgl"]["port_path"] == str(fallback / "eval_test.json")
    assert rows["cadrl"]["port"] is None and rows["cadrl"]["gate"] is None
    for name, row in rows.items():
        assert row["reference"] == ref[name]
        assert row["reference_path"] == f"results/{name}/eval_test.json"
        line = [ln for ln in text.splitlines()
                if ln.startswith(f"| {name} |")][0]
        assert f"{ref[name]['success_rate']:.3f} / " in line
        if row["port"] is not None:
            assert row["delta_success"] == pytest.approx(
                row["port"]["success_rate"] - ref[name]["success_rate"])
            assert f"{row['port']['success_rate']:.3f} / " in line
            assert f"| {row['gate']} |" in line
        else:
            assert "— (missing)" in line
    assert f"±{rq.GATE}" in text.splitlines()[0]


def test_one_row_trains_and_evaluates_on_the_cpu(tmp_path, monkeypatch):
    """A SARL row at toy counts: ``cli.train`` then ``cli.test`` as
    subprocesses, the record in the row's directory, the table's row."""
    cfg = tmp_path / "toy_sarl.py"
    cfg.write_text(TOY_CONFIG.replace(
        "policy=PolicyConfig(mprl=MPRLConfig(planning_depth=2,\n"
        "                                            planning_width=2)),",
        'policy=PolicyConfig(name="sarl"),'))
    row = {"name": "sarl", "policy": "sarl", "config": str(cfg),
           "train_args": ["--rl_train_episodes", "6",
                          "--evaluation_interval", "3",
                          "--target_update_interval", "3", "--val_size", "4",
                          "--train_envs", "4", "--collect_steps", "16"],
           "test_args": ["--test_size", "8"]}
    monkeypatch.setattr(rq, "RUNS", [row])
    data = tmp_path / "data"
    assert rq.main(["--data_dir", str(data), "--device", "cpu"]) == 0
    out = data / "sarl"
    log = (data / "sarl.reproduce.log").read_text()
    assert "INFO: IL demonstrations" in log  # the training's output kept
    assert '"cases": 8' in log
    assert (out / "config.py").read_text() == cfg.read_text()
    record = json.loads((out / "eval_test.json").read_text())
    assert record["cases"] == 8 and record["checkpoint"] == "rl_model_best"
    rows = json.loads((data / "quality_table.json").read_text())
    assert rows["sarl"]["port"] == record
    assert rows["sarl"]["gate"] in ("pass", "miss")
    # --skip_existing reuses the finished run
    calls = []
    monkeypatch.setattr(rq, "run", lambda cmd, log: calls.append(cmd) or 0)
    rq.main(["--data_dir", str(data), "--device", "cpu", "--skip_existing"])
    assert calls == []


def test_committed_fallback_covers_every_row_the_reference_retrains():
    """Every trained row without a committed run of the reference (the
    rows its table retrains: sarl, lstm_rl, cadrl, mp_unicycle, sarl_om,
    mp_w4) has a run of the port committed, trained by this tool."""
    ref = _reference()
    retrained = {r["name"] for r in ref.RUNS
                 if "config" in r and r["name"] not in ref.COMMITTED_FALLBACK}
    assert retrained == {"sarl", "lstm_rl", "cadrl", "mp_unicycle",
                         "sarl_om", "mp_w4"}
    assert retrained <= set(rq.COMMITTED_FALLBACK)
    for name in retrained:
        assert rq.COMMITTED_FALLBACK[name] == f"{PORT}/results/{name}_s0"
        assert (ROOT / rq.COMMITTED_FALLBACK[name] / "eval_test.json"
                ).exists(), name


def test_table_reads_the_committed_unicycle_and_w4_records(tmp_path):
    """With nothing regenerated, the table's ``mp_unicycle`` and ``mp_w4``
    rows are the port's committed records beside the reference's."""
    data = tmp_path / "data"
    rq.main(["--table_only", "--only", "mp_unicycle,mp_w4",
             "--data_dir", str(data)])
    rows = json.loads((data / "quality_table.json").read_text())
    for name in ("mp_unicycle", "mp_w4"):
        path = f"{PORT}/results/{name}_s0/eval_test.json"
        assert rows[name]["port_path"] == path
        assert rows[name]["port"] == json.loads((ROOT / path).read_text())
        assert rows[name]["reference_path"] == f"results/{name}/eval_test.json"
        assert rows[name]["gate"] in ("pass", "miss")
