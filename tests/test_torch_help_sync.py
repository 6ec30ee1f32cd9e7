"""The port's side of ``tools/check_help_sync.py``: the serving CLIs'
``--help`` stays in sync with the code.

For ``python -m repro_torch.launch.serve`` and ``python -m
repro_torch.examples.drift_serve``, the four checks of the reference's
tool, built from the port's own ``OP_LADDER``, ``configs.list_archs()``,
paradigm registry and ``DEFAULT_INTERVAL``: every operating point of the
ladder named, every scheduling, streaming and offload flag present,
every registered arch and every paradigm word named, and the
``--rollback-interval`` default rendered from ``DEFAULT_INTERVAL``. Each
of those lists is also held ``==`` the reference's (the tool's
constants read from ``tools/check_help_sync.py`` itself).
"""
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro import configs as jconfigs
from repro.core.dvfs import OP_LADDER as J_OP_LADDER
from repro.core.rollback import DEFAULT_INTERVAL as J_DEFAULT_INTERVAL
from repro.serving import servable as jservable
from repro_torch import configs
from repro_torch.core.dvfs import OP_LADDER
from repro_torch.core.rollback import DEFAULT_INTERVAL
from repro_torch.serving import servable

ROOT = Path(__file__).resolve().parents[1]
CLIS = ("repro_torch.launch.serve", "repro_torch.examples.drift_serve")
REQUIRED_FLAGS = ("--op", "--priority", "--deadline", "--step-budget",
                  "--stream", "--batch", "--steps", "--arch",
                  "--metrics-port", "--no-telemetry",
                  "--rollback-interval", "--offload",
                  "--energy-budget", "--quality-floor", "--trace-dir")
PARADIGM_WORDS = ("diffusion", "autoregressive", "unsupported")
INTERVAL_DEFAULT_TEXT = f"default: {DEFAULT_INTERVAL},"


def _tool():
    """The reference's ``tools/check_help_sync.py`` as a module (its
    constants; its ``main`` is not run)."""
    spec = importlib.util.spec_from_file_location(
        "ref_check_help_sync", ROOT / "tools" / "check_help_sync.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("module", CLIS)
def test_help_names_ladder_flags_archs_and_interval(module):
    out = subprocess.run(
        [sys.executable, "-m", module, "--help"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, check=True).stdout
    missing = [p.name for p in OP_LADDER if p.name not in out]
    missing += [f for f in REQUIRED_FLAGS if f not in out]
    missing += [a for a in configs.list_archs() if a not in out]
    missing += [w for w in PARADIGM_WORDS if w not in out]
    if INTERVAL_DEFAULT_TEXT not in out:
        missing.append(INTERVAL_DEFAULT_TEXT)
    assert not missing, f"{module} --help misses {missing}"


def test_lists_equal_the_reference():
    tool = _tool()
    assert [p.name for p in OP_LADDER] == [p.name for p in J_OP_LADDER]
    assert configs.list_archs() == jconfigs.list_archs()
    assert servable.PARADIGM_BY_FAMILY == jservable.PARADIGM_BY_FAMILY
    assert DEFAULT_INTERVAL == J_DEFAULT_INTERVAL
    assert REQUIRED_FLAGS == tool.REQUIRED_FLAGS
    assert PARADIGM_WORDS == tool.PARADIGM_WORDS
    assert INTERVAL_DEFAULT_TEXT == tool.INTERVAL_DEFAULT_TEXT
    assert sorted(configs.ALL_ARCHS) == sorted(configs._MODULES)
