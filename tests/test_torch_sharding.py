"""The port's declarative sharding (``howtotrainyourmamlpytorch_tpu_torch/
parallel/sharding.py``) and the differentiable collectives of the tensor-
parallel half against the JAX package's ``parallel/sharding.py`` (CPU).

* The spec of every leaf of every learner family's state equals JAX's
  ``guard_divisible(match_partition_rules(MP_STATE_RULES, ...))`` at mp 2
  and 4 (JAX ``tests/test_sharding.py:200-300``), and so do the rule
  table's edge cases: the first match wins, an unmatched leaf raises, a
  scalar is never partitioned, the guard works axis by axis.
* One two-rank gloo group at mp 2 (``tp_pair``, one launch for the
  module): the four collectives in float64 against a one-process gather
  and slice, forward, gradient and the gradient of the gradient; shard
  then gather, and a JAX state converted, sharded and gathered, both
  bitwise; a checkpoint saved at mp 2 loads bitwise on one process and a
  one-process checkpoint loads bitwise into each rank's blocks; each rank
  holds exactly half the bytes of every sharded leaf.
"""

import os
import re
import subprocess
import sys
import textwrap
import types

import jax
import numpy as np
import pytest
import torch

from howtotrainyourmamlpytorch_tpu.models import (
    ANILLearner as JANILLearner,
    GradientDescentLearner as JGradientDescentLearner,
    MatchingNetsLearner as JMatchingNetsLearner,
    ProtoNetsLearner as JProtoNetsLearner,
)
from howtotrainyourmamlpytorch_tpu.models import MAMLFewShotLearner as JLearner
from howtotrainyourmamlpytorch_tpu.parallel import sharding as jsharding
from howtotrainyourmamlpytorch_tpu.parallel.sharding import P
from howtotrainyourmamlpytorch_tpu_torch.convert import train_state_from_numpy
from howtotrainyourmamlpytorch_tpu_torch.models import (
    ANILLearner,
    GradientDescentLearner,
    MAMLFewShotLearner,
    MatchingNetsLearner,
    ProtoNetsLearner,
    build_backbone,
)
from howtotrainyourmamlpytorch_tpu_torch.parallel import Mesh, distributed, param_shardings
from howtotrainyourmamlpytorch_tpu_torch.parallel import sharding
from howtotrainyourmamlpytorch_tpu_torch.utils.trees import tree_leaves, tree_map

from test_torch_train import (  # noqa: F401 (one_intra_op_thread)
    jax_config,
    jax_train_state_numpy,
    one_intra_op_thread,
    port_config,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Learner families and their configs (the JAX learner, the port's).
RESNET = {"architecture": "resnet12", "num_filters": 2, "num_classes": 3,
          "image_channels": 3, "image_height": 16, "image_width": 16}
FAMILIES = {
    "maml_vgg": (JLearner, MAMLFewShotLearner, {}),
    "maml_vgg6": (JLearner, MAMLFewShotLearner, {"num_filters": 6}),
    "maml_resnet12": (JLearner, MAMLFewShotLearner, RESNET),
    "maml_layer_norm": (JLearner, MAMLFewShotLearner, {"norm_layer": "layer_norm"}),
    "anil": (JANILLearner, ANILLearner, {}),
    "gradient_descent": (JGradientDescentLearner, GradientDescentLearner, {}),
    "matching_nets": (JMatchingNetsLearner, MatchingNetsLearner, {}),
    "protonets": (JProtoNetsLearner, ProtoNetsLearner, {}),
}


def _mesh(dp, mp):
    """A layout's extents, which is all either package's guard reads."""
    return types.SimpleNamespace(shape={"dp": dp, "mp": mp})


def _canonical(name: str) -> str:
    """A JAX state's leaf path in the port's terms: optax's chain, mask and
    hyperparameter wrappers dropped (``opt_state/mu/...``)."""
    name = re.sub(r"^opt_state/.*?(mu|nu)/", r"opt_state/\1/", name)
    name = re.sub(r"^opt_state/.*count$", "opt_state/count", name)
    return name.replace("opt_state/hyperparams/", "opt_state/")


def _jax_specs(tree, mesh):
    specs = jsharding.match_partition_rules(jsharding.MP_STATE_RULES, tree)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    return {_canonical(jsharding.tree_path_name(path)):
            tuple(jsharding.guard_divisible(mesh, spec, leaf))
            for (path, leaf), spec in zip(flat, spec_leaves)}


def _spec_list(tree, specs) -> list:
    """``specs``' leaves in ``tree``'s order."""
    out = []
    sharding.map_with_specs(lambda _, spec: out.append(spec), tree, specs)
    return out


def _port_specs(tree, mesh):
    names = []
    sharding.named_tree_map(lambda name, _: names.append(name), tree)
    guarded = sharding.tree_shardings(mesh, tree, sharding.MP_STATE_RULES)
    return dict(zip(names, _spec_list(tree, guarded)))


@pytest.fixture(scope="module")
def family_states():
    """Each family's JAX state and the port's, made once for both mps."""
    cache = {}

    def get(name):
        if name not in cache:
            jcls, cls, backbone = FAMILIES[name]
            jcfg = jax_config(False, backbone=dict(backbone))
            cache[name] = (jcls(jcfg).init_state(jax.random.PRNGKey(0)),
                           cls(port_config(jcfg)).init_state(
                               torch.Generator().manual_seed(0), "cpu"))
        return cache[name]

    return get


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_every_leaf_spec_equals_jax(family_states, family, mp):
    """Leaf by leaf over a whole state, the optimizer moments included;
    the table shards something in every family but where no width divides
    (6 filters at mp 4), and the guard replicates what does not divide
    (ResNet-12's first stage of 2 at mp 4)."""
    jstate, state = family_states(family)
    mesh = _mesh(8 // mp, mp)
    want = _jax_specs(jstate, mesh)
    got = _port_specs(state, mesh)
    assert got == want
    # 6 filters at mp 4: no width divides, every leaf replicated.
    replicated = family == "maml_vgg6" and mp == 4
    assert any(sharding.is_sharded(spec) for spec in got.values()) != replicated
    if family == "maml_vgg6":
        assert got["theta/conv0/conv/weight"] == ((None,) if replicated else ("mp",))


def test_first_match_wins_as_in_jax():
    """``(^|/)lslr/`` precedes ``conv/weight$``: an LSLR table whose path
    ends in conv/weight stays replicated, theta's conv weight and its
    Adam moment shard over mp."""
    tree = {
        "lslr": {"conv0": {"conv": {"weight": np.zeros(3)}}},
        "theta": {"conv0": {"conv": {"weight": np.zeros((8, 4, 3, 3))}}},
        "opt_state": {"mu": {"theta": {"conv0": {"conv": {
            "weight": np.zeros((8, 4, 3, 3))}}}}},
    }
    want = jsharding.match_partition_rules(jsharding.MP_STATE_RULES, tree)
    got = sharding.match_partition_rules(
        sharding.MP_STATE_RULES, jax.tree.map(torch.from_numpy, tree))
    for path in (("lslr",), ("theta",), ("opt_state", "mu", "theta")):
        w, g = want, got
        for key in path + ("conv0", "conv", "weight"):
            w, g = w[key], g[key]
        assert g == tuple(w)
    assert got["theta"]["conv0"]["conv"]["weight"] == ("mp",)


def test_an_unmatched_leaf_raises_and_scalars_stay_whole():
    with pytest.raises(ValueError, match="no partition rule matched"):
        jsharding.match_partition_rules(((r"conv/weight$", P("mp")),),
                                        {"bias": np.zeros(4)})
    with pytest.raises(ValueError, match="no partition rule matched leaf 'bias'"):
        sharding.match_partition_rules(((r"conv/weight$", ("mp",)),),
                                       {"bias": torch.zeros(4)})
    tree = {"count": np.zeros(()), "one": np.zeros(1), "vec": np.zeros(8)}
    want = jsharding.match_partition_rules(((r".*", P("dp")),), tree)
    got = sharding.match_partition_rules(((r".*", ("dp",)),),
                                         jax.tree.map(torch.from_numpy, tree))
    assert got == {k: tuple(v) for k, v in want.items()}
    assert got == {"count": (), "one": (), "vec": ("dp",)}


def test_the_guard_replicates_axis_by_axis_as_jax():
    mesh = _mesh(2, 4)
    for spec, shape in ((("mp", None), (5, 16)), ((None, "mp"), (5, 16)),
                        (("dp", "mp"), (4, 16)), (("dp", "mp"), (3, 6))):
        leaf = np.zeros(shape)
        assert (sharding.guard_divisible(mesh, spec, torch.from_numpy(leaf))
                == tuple(jsharding.guard_divisible(mesh, P(*spec), leaf)))


def test_param_shardings_cover_the_resnet_tree():
    """JAX ``tests/test_resnet.py:176``: ResNet-12's conv filters over mp,
    the BN affine rows on their feature axis, the shortcut, the head
    row-parallel; without ``shard_model`` every leaf replicated."""
    cfg = port_config(jax_config(False, backbone=dict(RESNET, num_filters=4)))
    params, _ = build_backbone(cfg.backbone).init(torch.Generator().manual_seed(0))
    specs = param_shardings(_mesh(2, 2), params, shard_model=True)
    assert specs["res0"]["conv0"]["conv"]["weight"] == ("mp",)
    assert specs["res0"]["conv0"]["norm"]["gamma"] == (None, "mp")
    assert specs["res0"]["shortcut"]["conv"]["weight"] == ("mp",)
    assert specs["linear"]["weight"] == (None, "mp")
    replicated = param_shardings(_mesh(2, 2), params)
    assert set(_spec_list(params, replicated)) == {()}


def test_sequential_learners_keep_a_replicated_state_on_mp_layouts():
    """JAX ``tests/test_mesh_train.py:327``: only MAML and ANIL declare
    ``supports_model_sharding``; the other learners' state is replicated
    on an mp layout, and shard_state leaves it as it is."""
    mesh = Mesh(dp=1, mp=2, rank=1, world=2, device=torch.device("cpu"))
    cfg = port_config(jax_config(False))
    for cls in (GradientDescentLearner, MatchingNetsLearner, ProtoNetsLearner):
        learner = cls(cfg, mesh=mesh)
        assert not learner.supports_model_sharding
        state = learner.init_state(torch.Generator().manual_seed(0), "cpu")
        specs = _spec_list(state, learner.state_shardings(state))
        assert specs and set(specs) == {()}
        assert learner.shard_state(state) is state
    for cls in (MAMLFewShotLearner, ANILLearner):
        learner = cls(cfg, mesh=mesh)
        assert learner.supports_model_sharding
        assert any(tree_leaves(learner.sharded_theta()))


def test_a_rank_holds_its_block_of_each_sharded_leaf():
    """``shard_state`` on rank 1 of mp 2: every sharded leaf is the second
    contiguous block of the whole one, in storage of its own and of half
    its bytes; replicated leaves are the whole ones."""
    mesh = Mesh(dp=1, mp=2, rank=1, world=2, device=torch.device("cpu"))
    learner = MAMLFewShotLearner(port_config(jax_config(False)), mesh=mesh)
    state = learner.init_state(torch.Generator().manual_seed(0), "cpu")
    state = state._replace(theta=tree_map(torch.randn_like, state.theta))
    blocks = learner.shard_state(state)
    specs = learner.state_shardings(state)
    halves = []

    def check(pair, spec):
        whole, block = pair
        if not sharding.is_sharded(spec):
            assert block is whole
            return
        axis = spec.index("mp")
        n = whole.shape[axis] // 2
        assert torch.equal(block, whole.narrow(axis, n, n))
        assert block.untyped_storage().nbytes() * 2 == whole.untyped_storage().nbytes()
        halves.append(axis)

    sharding.map_with_specs(check, _pairs(state, blocks), specs)
    assert len(halves) >= 3 * 4  # theta and both moments of every conv and norm


def _pairs(a, b):
    """A tree of ``_Pair(a_leaf, b_leaf)`` leaves."""
    if isinstance(a, dict):
        return {k: _pairs(a[k], b[k]) for k in a}
    if isinstance(a, tuple):
        pairs = [_pairs(x, y) for x, y in zip(a, b)]
        return type(a)(*pairs) if hasattr(a, "_fields") else tuple(pairs)
    return None if a is None else _Pair(a, b)


class _Pair:
    """Two leaves that a tree walk treats as one."""

    def __init__(self, a, b):
        self.a, self.b = a, b

    def __iter__(self):
        return iter((self.a, self.b))


# ---------------------------------------------------------------------------
# A two-rank gloo group at mp 2
# ---------------------------------------------------------------------------

WORKER = textwrap.dedent(
    """
    import os
    import sys

    import torch
    from torch.autograd import grad

    from howtotrainyourmamlpytorch_tpu_torch.models import MAMLFewShotLearner
    from howtotrainyourmamlpytorch_tpu_torch.parallel import (
        collectives, initialize_distributed, make_mesh,
    )

    address, rank, work = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    torch.set_num_threads(1)
    assert initialize_distributed(address, 2, rank, 60.0, cpu=True)
    mesh = make_mesh(data_parallel=1, model_parallel=2, device="cpu")
    inputs = torch.load(f"{work}/inputs.pt", weights_only=False)
    group, r = mesh.mp_group, mesh.mp_index
    out = {"mesh": (mesh.dp, mesh.mp, mesh.rank, mesh.dp_index, mesh.mp_index)}

    def orders(f, x, v):
        x = x.clone().requires_grad_()
        y, loss = f(x)
        (g,) = grad(loss, x, create_graph=True)
        (h,) = grad((v * g).sum(), x)
        return y.detach(), g.detach(), h

    c = inputs["c"]
    out["all_gather"] = orders(
        lambda x: (y := collectives.AllGather.apply(x, 0, group, 2, r),
                   (c[r] * y.square()).sum()), inputs["x"][r], inputs["v"][r])
    out["reduce_scatter"] = orders(
        lambda z: (y := collectives.ReduceScatter.apply(z, 0, group, 2, r),
                   (c[r][:2] * y.square()).sum()), inputs["z"][r], inputs["vz"][r])
    out["all_reduce"] = orders(
        lambda p: (y := collectives.AllReduce.apply(p, group),
                   (inputs["c_rep"] * y.square()).sum()), inputs["p"][r], inputs["v"][r])
    out["copy"] = orders(
        lambda x: (y := collectives.CopyToShards.apply(x, group),
                   (c[r][:2] * y.square()).sum()), inputs["x_rep"], inputs["v_rep"])
    out["counts"] = dict(collectives.collective_counts)

    learner = MAMLFewShotLearner(inputs["cfg"], mesh=mesh)
    for name in ("state", "jax_state"):
        blocks = learner.shard_state(inputs[name])
        out[name] = (blocks, learner.gather_state(blocks))
    # Saved at mp 2 after a step; a one-process checkpoint loaded.
    state = learner.replicate(inputs["jax_state"])
    batch = learner._device_batch(state, inputs["batch"])
    state, _ = learner._train_step(state, batch, inputs["importance"], second_order=True)
    whole = learner.gather_state(state)
    if rank == 0:
        os.makedirs(f"{work}/tp_saved")
        learner.save_model(f"{work}/tp_saved/train_model_1", whole, {"current_iter": 1})
    out["trained"] = (state, whole)
    loaded, exp_state = learner.load_model(f"{work}/one_saved", "train_model", 0, "cpu")
    out["loaded"] = (learner.replicate(loaded), exp_state)
    torch.save(out, f"{work}/rank{rank}.pt")
    """
)


@pytest.fixture(scope="module")
def tp_pair(tmp_path_factory):
    """Both ranks' outputs, their inputs, and the one-process learner."""
    rng = np.random.RandomState(7)
    work = tmp_path_factory.mktemp("tp_pair")
    f64 = lambda *shape: torch.from_numpy(rng.randn(*shape))  # noqa: E731
    jcfg = jax_config(True, second_order=True, backbone={"num_filters": 8})
    jlearner = JLearner(jcfg)
    jstate = train_state_from_numpy(
        jax_train_state_numpy(jlearner.init_state(jax.random.PRNGKey(9))),
        jcfg.meta_learning_rate, "cpu")
    learner = MAMLFewShotLearner(port_config(jcfg))
    state = learner.init_state(torch.Generator().manual_seed(4), "cpu")
    from test_torch_train import episode_batch

    inputs = {
        "x": [f64(2, 3), f64(2, 3)], "c": [f64(4, 3), f64(4, 3)],
        "v": [f64(2, 3), f64(2, 3)], "z": [f64(4, 3), f64(4, 3)],
        "vz": [f64(4, 3), f64(4, 3)], "p": [f64(2, 3), f64(2, 3)],
        "c_rep": f64(2, 3), "x_rep": f64(2, 3), "v_rep": f64(2, 3),
        "cfg": learner.cfg, "state": state, "jax_state": jstate,
        "batch": episode_batch(rng, tasks=2), "importance": torch.tensor([0.3, 0.7]),
    }
    torch.save(inputs, work / "inputs.pt")
    one_state, _ = learner._train_step(
        jstate, learner._device_batch(jstate, inputs["batch"]), inputs["importance"],
        second_order=True)
    (work / "one_saved").mkdir()
    learner.save_model(str(work / "one_saved" / "train_model_0"), one_state,
                       {"current_iter": 3})
    (work / "worker.py").write_text(WORKER)
    address = f"127.0.0.1:{distributed.find_free_port()}"
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, str(work / "worker.py"), address,
                               str(rank), str(work)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for rank in (0, 1)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], "\n".join(logs)
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
    # The layout's specs, from a learner on a layout like the ranks'.
    tp_learner = MAMLFewShotLearner(learner.cfg, mesh=Mesh(
        dp=1, mp=2, rank=0, world=2, device=torch.device("cpu")))
    return dict(inputs=inputs, ranks=ranks, work=work, learner=learner,
                tp_learner=tp_learner, one_state=one_state)


def _reference(inputs):
    """The four collectives' global functions on one process: each rank's
    ``(y, dL/dx, d(v . dL/dx)/dx)``."""
    from torch.autograd import grad

    c, out = inputs["c"], {}

    def run(name, make, loss_of, v_of):
        xs = make()
        ys, loss = loss_of(xs)
        gs = grad(loss, xs, create_graph=True)
        hs = grad(sum((v * g).sum() for v, g in zip(v_of, gs)), xs)
        out[name] = [(ys[r].detach(), gs[r].detach(), hs[r]) for r in (0, 1)]

    # The blocks concatenated; each rank's loss on the whole.
    run("all_gather", lambda: [a.clone().requires_grad_() for a in inputs["x"]],
        lambda xs: ([torch.cat(xs)] * 2,
                    sum((c[r] * torch.cat(xs).square()).sum() for r in (0, 1))),
        inputs["v"])
    # The sum, each rank's loss on its block of it.
    run("reduce_scatter", lambda: [a.clone().requires_grad_() for a in inputs["z"]],
        lambda zs: ([(zs[0] + zs[1])[2 * r:2 * r + 2] for r in (0, 1)],
                    sum((c[r][:2] * (zs[0] + zs[1])[2 * r:2 * r + 2].square()).sum()
                        for r in (0, 1))),
        inputs["vz"])
    # The sum, one replicated loss on it.
    run("all_reduce", lambda: [a.clone().requires_grad_() for a in inputs["p"]],
        lambda ps: ([ps[0] + ps[1]] * 2,
                    (inputs["c_rep"] * (ps[0] + ps[1]).square()).sum()),
        inputs["v"])
    # One replicated input, each rank's loss on it; one replicated
    # gradient.
    x = inputs["x_rep"].clone().requires_grad_()
    loss = sum((c[r][:2] * x.square()).sum() for r in (0, 1))
    (g,) = grad(loss, x, create_graph=True)
    (h,) = grad((inputs["v_rep"] * g).sum(), x)
    out["copy"] = [(x.detach(), g.detach(), h)] * 2
    return out


@pytest.mark.parametrize("op", ["all_gather", "reduce_scatter", "all_reduce", "copy"])
def test_the_collectives_match_one_process_to_second_order(tp_pair, op):
    """Forward, gradient and gradient of the gradient in float64 against
    the same function on one process (a gather and a slice)."""
    want = _reference(tp_pair["inputs"])[op]
    for rank, out in enumerate(tp_pair["ranks"]):
        for got, ref, what in zip(out[op], want[rank], ("forward", "grad", "grad of grad")):
            assert got.dtype == torch.float64
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12,
                                       err_msg=f"{op} rank {rank} {what}")


def test_the_ranks_form_one_mp_group(tp_pair):
    for rank, out in enumerate(tp_pair["ranks"]):
        assert out["mesh"] == (1, 2, rank, 0, rank)
        # The three orders of four ops (a ReduceScatter's forward is an
        # all-reduce on gloo, counted as a reduce-scatter).
        assert out["counts"]["all_gather"] >= 3 and out["counts"]["reduce_scatter"] >= 3


def _assert_equal(a, b):
    """Bitwise, leaf by leaf, dicts matched by key."""
    checked = []
    tree_map(lambda x, y: checked.append(torch.equal(x, y)), a, b)
    assert checked and all(checked)


def _assert_blocks(whole, blocks, rank, learner):
    """Each sharded leaf of ``blocks`` is rank's half of ``whole``'s,
    bitwise, in half the bytes; each replicated one equal to it."""
    specs = learner.state_shardings(whole)

    def check(pair, spec):
        w, b = pair
        if sharding.is_sharded(spec):
            axis = spec.index("mp")
            n = w.shape[axis] // 2
            w = w.narrow(axis, rank * n, n)
            assert b.untyped_storage().nbytes() == w.numel() * w.element_size()
        assert torch.equal(b, w)

    sharding.map_with_specs(check, _pairs(whole, blocks), specs)


@pytest.mark.parametrize("name", ["state", "jax_state"])
def test_shard_then_gather_is_bitwise(tp_pair, name):
    """A port state, and a JAX state converted by ``convert.py``, each
    sharded to its rank's blocks and gathered back whole on both ranks."""
    whole = tp_pair["inputs"][name]
    for rank, out in enumerate(tp_pair["ranks"]):
        blocks, gathered = out[name]
        _assert_blocks(whole, blocks, rank, tp_pair["tp_learner"])
        _assert_equal(gathered, whole)
        assert {a.device.type for a in tree_leaves(gathered)} == {"cpu"}


def test_a_checkpoint_saved_at_mp_2_loads_bitwise_on_one_process(tp_pair):
    learner = tp_pair["learner"]
    loaded, exp_state = learner.load_model(str(tp_pair["work"] / "tp_saved"),
                                           "train_model", 1, "cpu")
    assert exp_state["current_iter"] == 1
    for rank, out in enumerate(tp_pair["ranks"]):
        blocks, whole = out["trained"]
        _assert_equal(whole, loaded)
        _assert_blocks(loaded, blocks, rank, tp_pair["tp_learner"])
    assert int(loaded.iteration) == 1


def test_a_one_process_checkpoint_loads_bitwise_into_each_ranks_blocks(tp_pair):
    for rank, out in enumerate(tp_pair["ranks"]):
        blocks, exp_state = out["loaded"]
        assert exp_state["current_iter"] == 3
        _assert_blocks(tp_pair["one_state"], blocks, rank, tp_pair["tp_learner"])


def test_the_import_check_walks_the_sharding_module():
    from test_torch_imports import _port_modules

    assert "howtotrainyourmamlpytorch_tpu_torch.parallel.sharding" in _port_modules()
