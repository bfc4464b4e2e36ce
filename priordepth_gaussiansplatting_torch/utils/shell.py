"""Shell commands of the port's chain CLIs (``convert``, ``train_image``,
``train_video``, ``SIBR_viewer``, ``full_eval``): each command is echoed and
run through the shell by ``os.system``, as the root scripts run theirs, and
judged by its own exit code, not by the wait status that ``os.system``
returns (a command that exits with 1 has the wait status 256, and
``sys.exit(256)`` ends a process with 0)."""

from __future__ import annotations

import os
import sys

PACKAGE = "priordepth_gaussiansplatting_torch"


def entry(name: str) -> str:
    """The command that starts the port's entry point `name`, where a root
    script's command names ``<name>.py``."""
    return f"{sys.executable} -m {PACKAGE}.{name}"


def system(cmd: str) -> int:
    """Echo `cmd`, run it through the shell, and return its exit code
    (128 + n when signal n ended it)."""
    print(f"$ {cmd}", flush=True)
    code = os.waitstatus_to_exitcode(os.system(cmd))
    return code if code >= 0 else 128 - code


def run(cmd: str) -> None:
    """:func:`system`, raising when the command fails."""
    code = system(cmd)
    if code != 0:
        raise RuntimeError(f"command failed (exit code {code}): {cmd}")
