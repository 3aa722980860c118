"""repro-lint on the port alone.

The lock-discipline checker keys classes by name and keeps the first of
each, so when all of ``src/`` is scanned the reference's
``GratingCache``, ``QueryEngine`` and ``VideoSearchServer`` shadow the
port's classes of the same names.  Linting ``src/repro_torch`` by itself
checks the port's own annotations; an unguarded write injected into a
copy of the port's ``GratingCache`` shows that the check bites.
"""

import os

from repro.analysis import format_text, run_lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")


def test_port_alone_is_lint_clean():
    findings = run_lint([PORT], root=REPO)
    active = [f for f in findings if not f.suppressed]
    assert not active, "\n" + format_text(findings)


def test_unguarded_write_in_port_grating_cache_is_caught(tmp_path):
    with open(os.path.join(PORT, "core", "engine.py")) as fh:
        src = fh.read()
    anchor = "    @staticmethod\n    def key_for("
    assert src.count(anchor) == 1
    injected = (
        "    def _unguarded(self):\n"
        "        self.misses = 0\n"
        "        self.hits += 1\n\n"
    )
    path = tmp_path / "engine.py"
    path.write_text(src.replace(anchor, injected + anchor))
    line = src[: src.index(anchor)].count("\n") + 1
    found = {
        (f.rule, f.line)
        for f in run_lint([str(path)], root=str(tmp_path))
        if not f.suppressed
    }
    assert found == {("LD201", line + 1), ("LD202", line + 2)}, found
