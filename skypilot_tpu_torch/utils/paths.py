"""Client-side state layout under ~/.stpu (overridable via STPU_HOME): the
part of the JAX package's ``utils/paths.py`` the port's observability
modules use, with the same names (the port imports nothing of that
package).

Reference analog: ~/.sky/{state.db,config.yaml,generated/,wheels/} --
sky/global_user_state.py:30, sky/backends/backend_utils.py:751.
"""
import os
import pathlib


def home() -> pathlib.Path:
    """STPU_HOME (default ~/.stpu), read on each call so a process that
    changes it writes under the new root."""
    root = pathlib.Path(os.environ.get("STPU_HOME", "~/.stpu")).expanduser()
    root.mkdir(parents=True, exist_ok=True)
    return root


def logs_dir() -> pathlib.Path:
    d = home() / "logs"
    d.mkdir(parents=True, exist_ok=True)
    return d
