"""Port parity, sequence parallelism on a mesh: docqa_tpu_torch's
``parallel/ring_attention.py`` (ring attention over ``batch_isend_irecv``
and Ulysses over ``all_to_all_single``) against docqa_tpu's on the same
mesh shapes, on the CPU: the reference tests' recipes
(tests/test_ring_attention.py: causal or not, lengths with GQA, fully
masked rows at zero, Ulysses, the model axis of a (2, 2) mesh), in float32
within their own 2e-5 (online-softmax merges in another order).

The process model is ``test_torch_mesh.py``'s.  Collective budgets from
``runtime.mesh.COLLECTIVES``: n - 1 ring rounds, four all-to-alls for
Ulysses, and one gather of the output shards for the global view.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from docqa_tpu.parallel.ring_attention import ring_attention as j_ring_attention
from docqa_tpu.parallel.ring_attention import ulysses_attention as j_ulysses_attention
from docqa_tpu.runtime import mesh as jmesh

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "torch_mesh_worker", os.path.join(os.path.dirname(__file__), "torch_mesh_worker.py"))
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)
_shape, _world_of, _counts = W.shape_of, W.world_of, W.counts_of
SHAPES = ["1x2", "1x4", "2x2"]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """One gloo world of each size for the module, started at once; its
    ranks run every scenario of this file."""
    out = {}
    for n, scenarios in ((2, "ring"), (4, "ring")):
        d = tmp_path_factory.mktemp(f"world{n}")
        out[n] = W.World(n, scenarios, d)
    yield out
    for w in out.values():
        w.close()


def _world(worlds, tag):
    return worlds[_world_of(tag)]


def _jmesh(tag):
    d, m = _shape(tag)
    return jmesh.host_cpu_mesh(d * m, data=d)


# ---- ring and Ulysses ----------------------------------------------------------

_RING = [(c, "1x4") for c in W.RING_CASES + W.ULYSSES_CASES]
_RING += [(c, "1x2") for c in W.RING_CASES + W.ULYSSES_CASES if c[0] in W.RING_ON_2]
_RING.append((W.RING_2D, "2x2"))


@pytest.mark.parametrize("case, tag", _RING, ids=[f"{c[0]}-{t}" for c, t in _RING])
def test_ring_and_ulysses_equal_the_reference(worlds, case, tag):
    name, b, s, hq, hkv, d, seed, causal, lengths = case
    n = _world_of(tag)
    mesh = _jmesh(tag)
    q, k, v = (jnp.asarray(a) for a in W.attn_inputs(b, s, hq, hkv, d, seed))
    lens = None if lengths is None else jnp.array(lengths, jnp.int32)
    ulysses = name.startswith("ulysses")
    fn = j_ulysses_attention if ulysses else j_ring_attention
    want = np.asarray(fn(q, k, v, mesh, causal=causal, lengths=lens))
    ring_n = _shape(tag)[1]
    for r in range(n):
        res = _world(worlds, tag).result("ring", r)
        np.testing.assert_allclose(res[name], want, atol=2e-5, rtol=0)
        if lengths is not None and 0 in lengths:  # fully masked rows are 0
            assert np.isfinite(res[name]).all() and not res[name][lengths.index(0)].any()
        if ulysses:
            assert _counts(res, name + "/") == {"all_to_all.ulysses": 4,
                                                "all_gather.ulysses": 1}
        else:
            assert _counts(res, name + "/") == {
                "ring_round.ring_attention": ring_n - 1, "all_gather.ring_attention": 1}


