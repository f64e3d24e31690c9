"""Helpers of the parity tests that hold the torch port's models against the
JAX package's: relative errors, and a JAX parameter (or gradient) tree
named as the port's ``named_parameters()`` name the same weights."""

import itertools
import re

import jax
import numpy as np
import pytest


def rel(got, exp) -> float:
    """Largest difference relative to the largest reference magnitude."""
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    return float(np.abs(got - exp).max() / max(np.abs(exp).max(), 1e-30))


def _paths(tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        yield ".".join(str(getattr(p, "key", p)) for p in path), leaf


def port_names(tree: dict, family: str) -> dict:
    """``{port parameter name: array}`` of a JAX tree of ``family``: the
    stacked ``[L, ...]`` subtrees (``layers``; Whisper's ``enc`` and
    ``dec``) one tree per layer, the rest under ``params``; InternVL's
    language model under ``lm.`` and its projector under ``proj``."""
    if family == "vlm":
        out = {f"lm.{k}": v for k, v in port_names(tree["lm"], "dense").items()}
        out.update({f"proj.{k}": v for k, v in _paths(tree["proj"])})
        return out
    stacks = ("enc", "dec") if family == "audio" else ("layers",)
    out = {}
    for key, sub in tree.items():
        if key in stacks:
            for i in range(jax.tree.leaves(sub)[0].shape[0]):
                layer = jax.tree.map(lambda a: np.asarray(a)[i], sub)
                out.update({f"{key}.{i}.{k}": v for k, v in _paths(layer)})
        else:
            out.update({f"params.{key}.{k}" if k else f"params.{key}": v
                        for k, v in _paths(sub)})
    return out


def assert_grads_match(model, jax_grads, family: str, tol: float = 1e-4):
    """Each of the port's gradients within ``tol`` of the largest magnitude
    of the JAX package's gradient of the same weight; every weight has
    one."""
    exp = port_names(jax_grads, family)
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(exp)
    for name, g in exp.items():
        assert got[name].grad is not None, name
        assert got[name].grad.shape == g.shape, name
        assert rel(got[name].grad.numpy(), g) <= tol, name


def _count_value(counter) -> int:
    return int(re.fullmatch(r"count\((-?\d+)\)", repr(counter)).group(1))


@pytest.fixture(scope="module", autouse=True)
def keep_reference_ids():
    """Run a test module on copies of the JAX package's process-wide task
    and buffer id counters, so that it leaves them where they were.  A
    chaos plan's fates hash transfer ids built from them, so
    ``tests/test_faults.py::test_fault_smoke_bit_identical`` injects no
    fault at some counter values and fails there; under ``--dist
    loadfile`` it may run after these modules in the same worker.  Import
    this fixture into every module that drives the JAX runtime."""
    import repro.core.buffer as buffer
    import repro.core.task_graph as task_graph
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((task_graph, "_task_ids"), (buffer, "_buffer_ids")):
            mp.setattr(mod, name,
                       itertools.count(_count_value(getattr(mod, name))))
        yield
