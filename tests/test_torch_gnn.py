"""The port's GNN (``repro_torch.models.gnn``) against the JAX package's
(``repro.models.gnn``) on the CPU: logits, loss, accuracy and every
gradient of ``loss_gnn`` for GCN, GIN and PNA, with the JAX ``init_gnn``
parameters carried across by ``gnn_params_from_jax``; masked edges,
the ``graph_ids`` readout, tied maxima from duplicate edges, and the
neighbour sampler's subgraphs.

Tolerance: rtol = atol = 1e-5, taken over each compared array:
|got - want| <= 1e-5 * max(1, max |want|).  The two frameworks sum the
scatters and the matrix products in other orders, so float32 results
differ in their last bits; the parameters are the same numbers.  The scale
is the array's, not the element's, because PNA's attenuation scaler
multiplies an in-degree-0 node's aggregates by delta / 1e-5 (about 1.6e5):
that node's activations reach hundreds, and a small logit beside them
carries float32 cancellation error of that scale in both frameworks alike
(at seed 1 each is 2e-5 and 5e-5 from a float64 run of the same numbers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import CSRGraph as JCSRGraph
from repro.data import NeighborSampler as JNeighborSampler
from repro.models import gnn as jgnn

from repro_torch.core.convert import gnn_params_from_jax, gnn_params_to_jax
from repro_torch.data import CSRGraph, NeighborSampler, synthetic_graph
from repro_torch.models import gnn as tgnn

TOL = 1e-5
KINDS = ["gcn", "gin", "pna"]


def _cfgs(kind, d_feat=8, n_classes=3, n_layers=2):
    kw = dict(name=f"{kind}-test", kind=kind, n_layers=n_layers, d_hidden=8,
              d_feat=d_feat, n_classes=n_classes)
    return jgnn.GNNConfig(**kw), tgnn.GNNConfig(**kw)


def _params(kind, jcfg, tcfg, seed=0):
    """(JAX params, the port's parameter tree with the same numbers)."""
    jp, _ = jgnn.init_gnn(jax.random.PRNGKey(seed), jcfg)
    model = tgnn.GNN(tcfg, device="cpu")
    model.load_state_dict(gnn_params_from_jax(jax.tree.map(np.asarray, jp)))
    return jp, model.tree()


def _graph(n=40, e=160, d_feat=8, n_classes=3, seed=1, pad_edges=0):
    """``synthetic_graph`` plus ``pad_edges`` masked random edges and the
    last two nodes masked out as padding."""
    g = synthetic_graph(n_nodes=n, n_edges=e, d_feat=d_feat, n_classes=n_classes, seed=seed)
    rng = np.random.default_rng(seed + 100)
    if pad_edges:
        extra = rng.integers(0, n, (2, pad_edges)).astype(np.int32)
        g["edge_index"] = np.concatenate([g["edge_index"], extra], axis=1)
        g["edge_mask"] = np.concatenate([g["edge_mask"], np.zeros(pad_edges, bool)])
    g["node_mask"][-2:] = False
    return g


def _run_jax(jp, g, jcfg):
    static = {k: v for k, v in g.items() if k == "n_graphs"}

    @jax.jit
    def run(p, arrays):
        jg = {**arrays, **static}
        return (jgnn.forward_gnn(p, jg, jcfg),
                jax.value_and_grad(jgnn.loss_gnn, has_aux=True)(p, jg, jcfg))

    logits, ((loss, m), grads) = run(jp, {k: jnp.asarray(v) for k, v in g.items()
                                          if k not in static})
    sd = gnn_params_from_jax(jax.tree.map(np.asarray, grads))
    return np.asarray(logits), float(loss), float(m["acc"]), {k: v.numpy() for k, v in sd.items()}


def _run_torch(tp, g, tcfg):
    tg = {k: torch.as_tensor(v) for k, v in g.items()}
    logits = tgnn.forward_gnn(tp, tg, tcfg)
    loss, m = tgnn.loss_gnn(tp, tg, tcfg)
    items = _items(tp)
    keys = [".".join(k) for k, _ in items]
    grads = torch.autograd.grad(loss, [v for _, v in items])
    return (logits.detach().numpy(), float(loss.detach()), float(m["acc"]),
            {k: g_.numpy() for k, g_ in zip(keys, grads)})


def _items(tree):
    from repro_torch.tree import flatten_with_path

    return list(flatten_with_path(tree))


def _close(got, want, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    err = float(np.abs(got - want).max(initial=0.0))
    assert err <= TOL * scale, f"{what}: max |got - want| {err} > {TOL} * {scale}"


def _assert_same(want, got):
    (wl, wloss, wacc, wg), (gl, gloss, gacc, gg) = want, got
    _close(gl, wl, "logits")
    _close(gloss, wloss, "loss")
    assert gacc == wacc
    assert set(gg) == set(wg)
    for k in wg:
        _close(gg[k], wg[k], k)


@pytest.mark.parametrize("kind", KINDS)
def test_state_dict_keys_are_the_jax_tree_paths(kind):
    jcfg, tcfg = _cfgs(kind)
    jp, _ = jgnn.init_gnn(jax.random.PRNGKey(0), jcfg)
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {k.replace(".", "/") for k in tgnn.GNN(tcfg, device="cpu").state_dict()}
    assert got == want
    if kind == "gin":
        assert "layers/0/mlp/1/w" in got and "layers/1/eps" in got


@pytest.mark.parametrize("kind", KINDS)
def test_params_round_trip_to_the_jax_tree(kind):
    jcfg, tcfg = _cfgs(kind)
    jp, _ = jgnn.init_gnn(jax.random.PRNGKey(3), jcfg)
    host = jax.tree.map(np.asarray, jp)
    back = gnn_params_to_jax(gnn_params_from_jax(host))
    assert jax.tree.structure(back) == jax.tree.structure(host)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(host)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("kind", KINDS)
def test_init_shapes_match_jax(kind):
    """Different draws by design, the same shapes and dtypes, and zero biases."""
    jcfg, tcfg = _cfgs(kind)
    jp, _ = jgnn.init_gnn(jax.random.PRNGKey(0), jcfg)
    tp = tgnn.init_gnn(torch.Generator().manual_seed(0), tcfg, device="cpu")
    assert [tuple(x.shape) for x in jax.tree.leaves(jp)] == \
        [tuple(v.shape) for _, v in _items(tp)]
    assert all(not bool(v.any()) for p, v in _items(tp) if p[-1] == "b")


@pytest.mark.parametrize("kind", KINDS)
def test_logits_loss_acc_and_grads_match_jax(kind):
    jcfg, tcfg = _cfgs(kind)
    jp, tp = _params(kind, jcfg, tcfg)
    g = _graph()
    _assert_same(_run_jax(jp, g, jcfg), _run_torch(tp, g, tcfg))


@pytest.mark.parametrize("kind", KINDS)
def test_masked_edges_are_inert(kind):
    """Masked edges, random and padded onto node N-1, change nothing, and
    the padded graph matches JAX."""
    jcfg, tcfg = _cfgs(kind)
    jp, tp = _params(kind, jcfg, tcfg, seed=1)
    g = _graph()
    gp = _graph(pad_edges=37)
    n = g["node_feat"].shape[0]
    tail = np.full((2, 11), n - 1, np.int32)
    gp["edge_index"] = np.concatenate([gp["edge_index"], tail], axis=1)
    gp["edge_mask"] = np.concatenate([gp["edge_mask"], np.zeros(11, bool)])
    plain, padded = _run_torch(tp, g, tcfg), _run_torch(tp, gp, tcfg)
    np.testing.assert_allclose(padded[0], plain[0], rtol=1e-6, atol=1e-6)
    for k in plain[3]:
        np.testing.assert_allclose(padded[3][k], plain[3][k], rtol=1e-6, atol=1e-6, err_msg=k)
    _assert_same(_run_jax(jp, gp, jcfg), padded)


@pytest.mark.parametrize("kind", KINDS)
def test_graph_ids_readout_matches_jax(kind):
    """Batched small simple graphs: logits pooled by ``graph_ids``, one label
    a graph."""
    jcfg, tcfg = _cfgs(kind, n_classes=2)
    jp, tp = _params(kind, jcfg, tcfg, seed=2)
    rng = np.random.default_rng(5)
    sizes = [5, 9, 7, 3]
    ids = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    n = len(ids)
    src, dst = [], []
    for s0, sz in zip(np.cumsum([0] + sizes[:-1]), sizes):
        pairs = rng.choice(sz * sz, size=2 * sz, replace=False)   # no edge twice
        src += list(s0 + pairs // sz)
        dst += list(s0 + pairs % sz)
    g = {
        "node_feat": rng.normal(size=(n, 8)).astype(np.float32),
        "edge_index": np.array([src, dst], np.int32),
        "edge_mask": np.ones(len(src), bool),
        "node_mask": np.ones(n, bool),
        "labels": rng.integers(0, 2, len(sizes)).astype(np.int32),
        "graph_ids": ids,
        "n_graphs": np.int32(len(sizes)),
    }
    _assert_same(_run_jax(jp, g, jcfg), _run_torch(tp, g, tcfg))


@pytest.mark.parametrize("kind", KINDS)
def test_tied_maxima_from_duplicate_edges_match_jax(kind):
    """Every node hears two distinct sources, each edge twice: PNA's max
    ties on the larger message's two copies and its min on the smaller's,
    and the tied gradients split as JAX's do.

    Two distinct sources keep each node's variance away from 0.  At a
    variance of exactly 0 (a node whose messages are all copies of one)
    PNA's std gradient, 0.5 / sqrt(1e-5) ~ 158 times the difference of two
    rounded terms, carries float32 cancellation in both frameworks alike
    (measured with every edge three or four times: JAX and the port 1.1e-4
    to 1.6e-4 from a float64 run on a gradient of scale 7), which would
    hide the tie rule under noise."""
    jcfg, tcfg = _cfgs(kind)
    jp, tp = _params(kind, jcfg, tcfg, seed=4)
    rng = np.random.default_rng(6)
    n = 24
    src = np.concatenate([rng.choice(n, 2, replace=False) for _ in range(n)])
    dst = np.repeat(np.arange(n), 2)
    g = synthetic_graph(n_nodes=n, n_edges=1, d_feat=8, n_classes=3, seed=6)
    g["edge_index"] = np.tile(np.stack([src, dst]).astype(np.int32), (1, 2))
    g["edge_mask"] = np.ones(4 * n, bool)
    _assert_same(_run_jax(jp, g, jcfg), _run_torch(tp, g, tcfg))


def test_scatter_max_ties_split_the_gradient_evenly():
    """Three tied messages into node 0 and one into node 1: each of the tied
    gets a third of node 0's gradient, in both frameworks."""
    msg = np.array([[2.0], [2.0], [2.0], [5.0], [1.0]], np.float32)
    dst = np.array([0, 0, 0, 1, 1], np.int32)
    jg = jax.grad(lambda m: jnp.sum(jax.ops.segment_max(m, jnp.asarray(dst), num_segments=3)
                                    [:2]))(jnp.asarray(msg))
    t = torch.tensor(msg, requires_grad=True)
    tgnn.scatter_max(t, torch.as_tensor(dst).long(), 3)[:2].sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=0, atol=1e-7)
    np.testing.assert_allclose(t.grad.numpy()[:, 0], [1 / 3, 1 / 3, 1 / 3, 1.0, 0.0], atol=1e-7)
    empty = tgnn.scatter_max(t, torch.as_tensor(dst).long(), 3)[2]
    assert bool(torch.isneginf(empty).all())


def _sampler_pair(seed=1):
    kw = dict(n_nodes=300, avg_degree=5, d_feat=8, n_classes=3, seed=seed)
    return (JNeighborSampler(JCSRGraph.random(**kw), fanouts=(4, 2), batch_nodes=8),
            NeighborSampler(CSRGraph.random(**kw), fanouts=(4, 2), batch_nodes=8))


@pytest.mark.parametrize("seed", [0, 7])
def test_neighbor_sampler_matches_jax(seed):
    js, ts = _sampler_pair()
    assert (js.max_nodes, js.max_edges) == (ts.max_nodes, ts.max_edges)
    want, got = js.sample(np.arange(8), seed=seed), ts.sample(np.arange(8), seed=seed)
    assert set(want) == set(got)
    for k in want:
        assert want[k].dtype == got[k].dtype and np.array_equal(want[k], got[k]), k
    jb, tb = next(js.batches(seed=seed)), next(ts.batches(seed=seed))
    assert all(np.array_equal(jb[k], tb[k]) for k in jb)


def test_sampler_feeds_the_port_gnn():
    """The counterpart of ``tests/test_models_graph.py::test_sampler_feeds_gnn``:
    a sampled subgraph through the port's GCN, against JAX's."""
    js, ts = _sampler_pair()
    batch = ts.sample(np.arange(8))
    jcfg, tcfg = _cfgs("gcn")
    jp, tp = _params("gcn", jcfg, tcfg)
    got = _run_torch(tp, batch, tcfg)
    assert np.isfinite(got[1])
    _assert_same(_run_jax(jp, js.sample(np.arange(8)), jcfg), got)


def test_module_forward_equals_functional():
    _, tcfg = _cfgs("pna")
    model = tgnn.GNN(tcfg, torch.Generator().manual_seed(1), device="cpu")
    g = {k: torch.as_tensor(v) for k, v in _graph().items()}
    assert torch.equal(model(g), tgnn.forward_gnn(model.tree(), g, tcfg))
    assert {id(p) for p in model.parameters()} == {id(v) for _, v in _items(model.tree())}
