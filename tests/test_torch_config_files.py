"""Every config file of the repo (``configs/icra_benchmark/*.py`` and every
``results/**/config.py``) loads in the port to the same fields as in the JAX
package, and the port's loader imports no JAX: the files import
``relationalgraphlearning_tpu.configs.base``, which it points at the
port's copy; any other import of the JAX package raises."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

from relationalgraphlearning_tpu.configs import base as jbase
from relationalgraphlearning_tpu_torch.configs import base as tbase

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted(str(p.relative_to(ROOT)) for p in
               [*ROOT.glob("configs/icra_benchmark/*.py"),
                *ROOT.glob("results/**/config.py")])


def test_every_config_file_is_found():
    assert len([f for f in FILES if f.startswith("configs/")]) == 13
    results = [f for f in FILES if f.startswith("results/")]
    assert len([f for f in results if f.count("/") == 2]) == 23
    assert len(results) == 29  # and six seed runs a level deeper
    assert "results/mprl_td/config.py" in FILES


@pytest.mark.parametrize("path", FILES)
def test_config_file_loads_field_equal(path):
    want = jbase.load_config_module(str(ROOT / path))
    got = tbase.load_config_module(str(ROOT / path))
    assert isinstance(got, tbase.Config)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.env.max_steps == want.env.max_steps


@pytest.mark.parametrize("line", [
    "import relationalgraphlearning_tpu\n",
    "from relationalgraphlearning_tpu.training import train_loop\n",
    "from relationalgraphlearning_tpu import configs\n",
    "import relationalgraphlearning_tpu.configs.base as b\n"])
def test_other_imports_of_the_jax_package_raise(tmp_path, line):
    p = tmp_path / "cfg.py"
    p.write_text(line + "def get_config():\n    return None\n")
    with pytest.raises(ImportError, match="cfg.py:1"):
        tbase.load_config_module(str(p))


def test_module_level_config_and_missing_entry_point(tmp_path):
    p = tmp_path / "cfg.py"
    p.write_text("from relationalgraphlearning_tpu.configs.base import (\n"
                 "    Config, EnvConfig)\nconfig = Config(env=EnvConfig("
                 "time_limit=30.0))\n")
    assert tbase.load_config_module(str(p)).env.max_steps == 120
    p.write_text("x = 1\n")
    with pytest.raises(AttributeError):
        tbase.load_config_module(str(p))


def test_loading_imports_no_jax():
    probe = (
        "import sys\n"
        "from relationalgraphlearning_tpu_torch.configs.base import "
        "load_config_module\n"
        f"for f in {FILES!r}:\n"
        "    load_config_module(f)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'relationalgraphlearning_tpu')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
