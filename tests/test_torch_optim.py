"""The port's optimizers, schedules and tree utilities against the JAX package.

``repro_torch.optim`` (sgd, momentum, adamw with weight decay and a
gradient clip, on plain and node-stacked leaves) over 5 steps against
``repro.optim`` at 1e-6 relative; the three schedules at steps 0..N to one
fp32 ulp; ``repro_torch.utils.tree``'s buffers and specs equal to
``repro.utils.tree``'s. Inputs are drawn with numpy from fixed seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("torch")  # the reference's CI installs no torch
import torch
torch.set_num_threads(1)  # one intra-op thread a test process: the tests' small CPU
# ops run faster so, and parallel test workers do not oversubscribe the cores

from repro.optim import make_optimizer as r_make_optimizer
from repro.optim import schedule as r_schedule
from repro.utils import tree as r_tree
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import dpsgd as t_dpsgd
from repro_torch.optim import make_optimizer
from repro_torch.optim import schedule as t_schedule
from repro_torch.utils import tree as t_tree

RTOL = 1e-6
STEPS = 5


def _tree(seed, n_nodes=None):
    """A model-like tree of dicts and lists: matrices, vectors and a 3-d
    leaf, with a leading node axis when ``n_nodes`` is given."""
    rng = np.random.default_rng(seed)
    lead = () if n_nodes is None else (n_nodes,)

    def draw(*shape):
        return rng.normal(size=lead + shape).astype(np.float32)
    return {"embed": {"embedding": draw(16, 8)},
            "unit": [{"w": draw(2, 8, 8), "b": draw(8)},
                     {"scale": draw(8)}],
            "final_norm": {"scale": draw(8)}}


def _assert_tree_close(got, want, rtol=RTOL, atol=0.0):
    g, w = t_dpsgd._leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


OPT_CASES = [
    ("sgd", {}),
    ("sgd", {"grad_clip": 0.5}),
    ("momentum", {"momentum": 0.9}),
    ("momentum", {"momentum": 0.9, "grad_clip": 1.0}),
    ("adamw", {}),
    ("adamw", {"weight_decay": 0.1}),
    ("adamw", {"weight_decay": 0.1, "grad_clip": 0.5}),
]


@pytest.mark.parametrize("nodes", [None, 4], ids=["replica", "node-stacked"])
@pytest.mark.parametrize("name,kw", OPT_CASES,
                         ids=[f"{n}-{'-'.join(kw) or 'plain'}"
                              for n, kw in OPT_CASES])
def test_optimizer_matches_reference_over_five_steps(name, kw, nodes):
    """Each step's parameters and optimizer state equal the JAX package's
    at 1e-6 relative, both fed the same gradients; on node-stacked leaves
    weight decay reaches the per-node vectors too (p.ndim >= 2) and the
    clip takes one norm over every node."""
    r_opt = r_make_optimizer(name, **kw)
    t_opt = make_optimizer(name, **kw)
    params = _tree(0, nodes)
    r_params = jax.tree.map(jnp.asarray, params)
    t_params = params_from_numpy(params, "cpu")
    r_state, t_state = r_opt.init(r_params), t_opt.init(t_params)
    lr = np.float32(0.05)
    for k in range(STEPS):
        grads = _tree(100 + k, nodes)
        r_params, r_state = r_opt.update(
            jax.tree.map(jnp.asarray, grads), r_state, r_params,
            jnp.asarray(lr))
        t_params, t_state = t_opt.update(
            params_from_numpy(grads, "cpu"), t_state, t_params,
            torch.tensor(lr))
        _assert_tree_close(t_params, r_params, atol=1e-7)
        _assert_tree_close(t_state, r_state, atol=1e-7)
    if name == "adamw":
        assert t_state["t"].dtype == torch.int32 and int(t_state["t"]) == 5


@pytest.mark.parametrize("name,kw", OPT_CASES,
                         ids=[f"{n}-{'-'.join(kw) or 'plain'}"
                              for n, kw in OPT_CASES])
def test_donated_update_is_bit_equal_and_in_place(name, kw):
    """``donate=True`` writes the new parameters and moments into the
    given tensors, each bit-equal to the functional update's, over
    ``STEPS`` steps on node-stacked leaves (one a bfloat16 leaf); a
    parameter whose nodes share memory (the node mean's expanded view)
    gets a new tensor, bit-equal too."""
    opt = make_optimizer(name, **kw)
    params = params_from_numpy(_tree(0, 4), "cpu")
    params["unit"][1]["scale"] = params["unit"][1]["scale"].to(
        torch.bfloat16)
    state = opt.init(params)
    lr = torch.tensor(np.float32(0.05))
    for k in range(STEPS):
        grads = params_from_numpy(_tree(100 + k, 4), "cpu")
        mine = t_dpsgd._tree_map(torch.clone, (params, state))
        norm = mine[0]["final_norm"]
        norm["scale"] = norm["scale"][:1].expand(4, -1)
        params["final_norm"]["scale"] = norm["scale"].clone()
        new, new_state = opt.update(grads, state, params, lr)
        got, got_state = opt.update(grads, *mine[::-1], lr, donate=True)
        for a, b in zip(t_dpsgd._leaves((got, got_state)),
                        t_dpsgd._leaves((new, new_state))):
            assert a.dtype == b.dtype and torch.equal(a, b)
        for a, b in zip(t_dpsgd._leaves(got), t_dpsgd._leaves(mine[0])):
            assert (a is b) == (b is not norm["scale"])
        params, state = new, new_state


def test_adamw_bias_correction_is_fp32():
    """The first step, where the bias corrections 1 - beta**t (fp32, of an
    int32 t) are smallest and scale the update most, on gradients far
    below the parameters: the update equals the reference's at 1e-6."""
    t_opt = make_optimizer("adamw")
    r_opt = r_make_optimizer("adamw")
    p = {"w": np.full((2, 2), 1.0, np.float32)}
    g = {"w": np.array([[1e-3, -2e-3], [3e-3, 4e-3]], np.float32)}
    t_new, _ = t_opt.update(params_from_numpy(g, "cpu"),
                            t_opt.init(params_from_numpy(p, "cpu")),
                            params_from_numpy(p, "cpu"), torch.tensor(0.1))
    r_new, _ = r_opt.update(jax.tree.map(jnp.asarray, g),
                            r_opt.init(jax.tree.map(jnp.asarray, p)),
                            jax.tree.map(jnp.asarray, p), jnp.float32(0.1))
    np.testing.assert_allclose(t_new["w"].numpy(), np.asarray(r_new["w"]),
                               rtol=RTOL)


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer("lion")


SCHEDULES = [
    ("constant_lr", (3e-4,)),
    ("cosine_lr", (1e-3, 20)),
    ("cosine_lr", (0.05, 7, 0.0)),
    ("warmup_cosine", (1e-3, 5, 20)),
    ("warmup_cosine", (0.1, 0, 3, 0.2)),
]


@pytest.mark.parametrize("name,args", SCHEDULES,
                         ids=[f"{n}{a}" for n, a in SCHEDULES])
def test_schedule_matches_reference(name, args):
    """Steps 0..N+3 (past the end): within one fp32 ulp, a 0-d fp32
    tensor of a 0-d int32 step."""
    r_f, t_f = getattr(r_schedule, name)(*args), getattr(t_schedule, name)(
        *args)
    for k in range(25):
        want = np.float32(r_f(jnp.asarray(k, jnp.int32)))
        got = t_f(torch.tensor(k, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


def test_tree_buffers_and_specs_equal_reference():
    """Buffers key for key (the JAX dtype names), the shapes / dtypes and
    groups of the spec, and the round trip, for plain and node buffers;
    bytes and parameter counts."""
    tree = _tree(1)
    tree["step"] = np.asarray(3, np.int32)
    tree["unit"][1]["half"] = np.arange(6, dtype=np.float32).reshape(2, 3)
    jtree = jax.tree.map(jnp.asarray, tree)
    jtree["unit"][1]["half"] = jtree["unit"][1]["half"].astype(jnp.bfloat16)
    ttree = params_from_numpy(tree, "cpu")
    ttree["unit"][1]["half"] = ttree["unit"][1]["half"].to(torch.bfloat16)

    r_bufs, r_spec = r_tree.tree_to_buffers(jtree)
    t_bufs, t_spec = t_tree.tree_to_buffers(ttree)
    assert list(t_bufs) == list(r_bufs)
    assert sorted(r_bufs) == ["bfloat16", "float32", "int32"]
    for key in r_bufs:
        np.testing.assert_array_equal(
            t_bufs[key].float().numpy(),
            np.asarray(r_bufs[key]).astype(np.float32))
    assert t_spec[1] == [(tuple(s), d) for s, d in r_spec[1]]
    assert t_spec[2] == r_spec[2]
    back = t_tree.buffers_to_tree(t_bufs, t_spec)
    for a, b in zip(t_dpsgd._leaves(back), t_dpsgd._leaves(ttree)):
        assert torch.equal(a, b)
    assert t_tree.tree_bytes(ttree) == r_tree.tree_bytes(jtree)
    assert t_tree.tree_param_count(ttree) == r_tree.tree_param_count(jtree)

    nodes = _tree(2, n_nodes=3)
    r_nb, r_nspec = r_tree.tree_to_node_buffers(
        jax.tree.map(jnp.asarray, nodes))
    t_nb, t_nspec = t_tree.tree_to_node_buffers(
        params_from_numpy(nodes, "cpu"))
    assert list(t_nb) == list(r_nb) == ["float32"]
    np.testing.assert_array_equal(t_nb["float32"].numpy(),
                                  np.asarray(r_nb["float32"]))
    assert t_nspec[1] == [(tuple(s), d) for s, d in r_nspec[1]]
    assert t_nspec[2] == r_nspec[2]
    back = params_to_numpy(t_tree.node_buffers_to_tree(t_nb, t_nspec))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(nodes)):
        np.testing.assert_array_equal(a, b)
