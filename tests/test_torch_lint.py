"""The reference's linter over the port: ``python -m hypha_tpu.analysis
hypha_tpu_torch/`` finds no violation, within the reference's suppression
budget (the counterpart of ``tests/test_lint.py::test_package_is_lint_clean``).

The linter is the JAX package's (``hypha_tpu/analysis``); a test may
import it, the port never does.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from hypha_tpu.analysis import DEFAULT_SUPPRESSION_BUDGET, lint_paths

REPO = Path(__file__).parent.parent
PORT = REPO / "hypha_tpu_torch"


def test_port_is_lint_clean():
    report = lint_paths([PORT], protocol_checks=False)
    assert not report.parse_errors, report.parse_errors
    assert not report.active, "\n".join(v.render() for v in report.active)
    assert len(report.suppression_sites) <= DEFAULT_SUPPRESSION_BUDGET


def test_cli_exits_zero_on_the_port():
    proc = subprocess.run(
        [sys.executable, "-m", "hypha_tpu.analysis", str(PORT)],
        capture_output=True, text=True, cwd=REPO, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 violation(s)" in proc.stdout
