"""The port's hot-path/API lint (``repro_torch.analysis.lint``), held to
``tests/test_analysis_lint.py``: every rule test on the same snippets, the
port's tree lint-clean, and both linters giving identical findings over
both packages' trees."""
import dataclasses
import os
import textwrap

import pytest

from repro.analysis import lint as ref_lint
from repro_torch.analysis.lint import lint_paths, lint_source

_ROOT = os.path.join(os.path.dirname(__file__), "..", "src")
_SRC = os.path.join(_ROOT, "repro_torch")


def _codes(src, **kw):
    return [f.code for f in lint_source(textwrap.dedent(src), **kw)]


# --------------------------------------------------------------------------
# public-assert
# --------------------------------------------------------------------------
def test_assert_on_public_function_flagged():
    assert _codes("""
        def api(x):
            assert x > 0
    """) == ["public-assert"]


def test_assert_in_private_helper_allowed():
    assert _codes("""
        def _helper(x):
            assert x > 0
    """) == []


def test_assert_in_nested_private_scope_allowed():
    assert _codes("""
        class Engine:
            def _step(self, x):
                assert x > 0
    """) == []


def test_assert_in_dunder_is_public():
    assert _codes("""
        class Engine:
            def __init__(self, x):
                assert x > 0
    """) == ["public-assert"]


def test_module_level_assert_flagged():
    assert _codes("assert True\n") == ["public-assert"]


# --------------------------------------------------------------------------
# metric-name
# --------------------------------------------------------------------------
def test_conforming_metric_name_passes():
    assert _codes("""
        m.counter("repro.serve.requests").inc()
        m.histogram("repro.tune.cache.load_s").observe(1.0)
    """) == []


def test_nonconforming_metric_names_flagged():
    assert _codes("""
        m.counter("requests").inc()
        m.gauge("repro.queueDepth").set(1)
    """) == ["metric-name", "metric-name"]


def test_dynamic_metric_name_not_checked():
    assert _codes("m.counter(name).inc()\n") == []


# --------------------------------------------------------------------------
# hot-path-alloc
# --------------------------------------------------------------------------
def test_allocation_in_disabled_path_flagged():
    assert _codes("""
        def _dispatch(self):
            if not self.enabled:
                tags = [1, 2]
    """) == ["hot-path-alloc"]


def test_stray_call_and_lock_in_disabled_path_flagged():
    found = _codes("""
        def _dispatch(self):
            if not enabled:
                with self._lock:
                    self.log("x")
    """)
    assert found == ["hot-path-alloc", "hot-path-alloc"]


def test_allowlisted_publish_in_disabled_path_passes():
    assert _codes("""
        def _dispatch(self):
            if not self.enabled:
                self._publish(DispatchRecord(n=len(group)))
    """) == []


def test_unguarded_branch_not_checked():
    assert _codes("""
        def _dispatch(self):
            if self.enabled:
                tags = [1, 2]
    """) == []


# --------------------------------------------------------------------------
# bare-except
# --------------------------------------------------------------------------
def test_bare_except_flagged_everywhere():
    assert _codes("""
        def _f():
            try:
                pass
            except:
                pass
    """) == ["bare-except"]


def test_broad_except_unguarded_module_ok():
    src = """
        def _f():
            try:
                pass
            except Exception:
                pass
    """
    assert _codes(src) == []
    assert _codes(src, guarded_except=True) == ["bare-except"]


def test_guarded_broad_except_with_noqa_or_reraise_ok():
    assert _codes("""
        def _f():
            try:
                pass
            except Exception:  # noqa: BLE001 — reviewed swallow
                pass
    """, guarded_except=True) == []
    assert _codes("""
        def _f():
            try:
                pass
            except BaseException:
                cleanup()
                raise
    """, guarded_except=True) == []


def test_syntax_error_reported_not_raised():
    assert _codes("def f(:\n") == ["syntax-error"]


# --------------------------------------------------------------------------
# the gate: the shipped tree is clean
# --------------------------------------------------------------------------
def test_src_tree_is_lint_clean():
    assert lint_paths(_SRC) == []


@pytest.mark.parametrize("tree", ["repro", "repro_torch"])
def test_same_findings_as_the_reference(tree):
    path = os.path.join(_ROOT, tree)
    assert [dataclasses.astuple(f) for f in lint_paths(path)] == \
        [dataclasses.astuple(f) for f in ref_lint.lint_paths(path)]


_SNIPPETS = [
    "def api(x):\n    assert x\n",
    "m.counter('requests').inc()\nm.gauge('repro.serve.depth').set(1)\n",
    "def _d(self):\n    if not self.enabled:\n        t = [len(g)]\n",
    "def _f():\n    try:\n        pass\n    except Exception:\n"
    "        pass\n",
    "def f(:\n",
]


@pytest.mark.parametrize("guarded", [False, True])
@pytest.mark.parametrize("snippet", _SNIPPETS)
def test_same_findings_on_snippets(snippet, guarded):
    got = lint_source(snippet, "x.py", guarded_except=guarded)
    want = ref_lint.lint_source(snippet, "x.py", guarded_except=guarded)
    assert [dataclasses.astuple(f) for f in got] == \
        [dataclasses.astuple(f) for f in want]
