"""Port parity, the trainers on a mesh: docqa_tpu_torch's
``make_train_step(mesh=)`` (data parallel x Megatron tensor parallel, the
vocabulary-parallel loss, the global clip), ``make_encoder_train_step(
mesh=)`` (data parallel with all-gathered negatives) and the sharded
``TrainCheckpointer`` against docqa_tpu's training plane, on the CPU.

The process model is ``test_torch_mesh.py``'s: the reference in this
process (one device, and the conftest's 8 virtual devices at (2, 4)), the
port SPMD in gloo worlds of 2 and 4 processes (``tests/torch_mesh_worker.py``)
on (1, 2), (1, 4) and (2, 2) for the LM, (2, 1), (4, 1) and (2, 2) for the
encoder.  Every LM batch is ragged, and its data shards hold different
token counts, so a mean of per-shard means would be another loss.

Tolerances, float32:
* LM losses within 2e-6 of the reference's on its carried tree (as
  tests/test_torch_train_lm.py: the row-parallel sums, the vocabulary-
  parallel softmax and the data reduction add in other orders), params as
  ``adam_close`` says; the clip's norm within 1e-5 relative of
  ``optax.global_norm`` of the reference's whole gradient;
* the replicated leaves' gradients and values, and the norm, bit-equal on
  every rank;
* encoder losses within 1e-5 of the reference's (its own test allows 1e-4:
  each rank sums its rows of both directions over the global batch, then
  the ranks' shares are summed); params within 1e-5, except elements whose
  gradient fell below 100 x Adam's eps (1e-6) at a step so far, which are
  within the distance the updates can move them (lr a step): Adam's update
  there is lr * g / (|g| + eps), and the sum's other order moves g by a
  fair part of itself (one element at 4e-8 parted by 1.1e-5 after a step);
* checkpoints bitwise: params, moments, step and count; steps after a
  restore on the saving mesh bitwise the uninterrupted run's, on another
  mesh within the LM tolerance.
"""

import importlib.util
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from docqa_tpu.config import DecoderConfig as JDecoderConfig
from docqa_tpu.config import EncoderConfig as JEncoderConfig
from docqa_tpu.runtime import mesh as jmesh
from docqa_tpu.training import encoder as jenc
from docqa_tpu.training import train as jtrain
from docqa_tpu_torch.config import DecoderConfig, EncoderConfig
from docqa_tpu_torch.runtime import mesh as tmesh
from docqa_tpu_torch.training import encoder, train
from docqa_tpu_torch.training.checkpoint import TrainCheckpointer
from docqa_tpu_torch.weights import host_init_decoder_params, host_init_encoder_params

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "torch_mesh_worker", os.path.join(os.path.dirname(__file__), "torch_mesh_worker.py"))
W = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(W)
_shape, _world_of, _counts = W.shape_of, W.world_of, W.counts_of
SHAPES = ["1x2", "1x4", "2x2"]
ENC_SHAPES = ["2x1", "4x1", "2x2"]
CFG = DecoderConfig(**W.TRAIN_WIDTHS)
JCFG = JDecoderConfig(**W.TRAIN_WIDTHS)
ENC_CFG = EncoderConfig(**W.ENC_WIDTHS)
TOL = 2e-6
ENC_TOL = 1e-5
NORM_RTOL = 1e-5
NEAR_EPS = 1e-6  # 100 x Adam's eps
LOST_TIMEOUT_S = 10
N_LEAVES = 3 + 9 * CFG.num_layers


def adam_close(got, want, lr, steps, what, tol=TOL):
    """All but 0.1 % of the elements within ``tol``, and every element
    within 5 % of the distance ``steps`` updates of ``lr`` can move it:
    Adam divides each gradient by its running RMS plus eps (1e-8), so an
    element whose gradient is near eps takes a step whose size hangs on
    rounding in that gradient."""
    diff = np.abs(got - want)
    assert (diff <= tol).mean() >= 0.999, (what, float(diff.max()))
    assert diff.max() <= 0.05 * lr * steps, (what, float(diff.max()))


def _one_device_save(root):
    """The port's mesh-less run that (1, 2) restores: two steps from
    CKPT_SEED's tree, saved at step 2."""
    state, opt = train.init_train_state(
        CFG, optimizer=train.default_optimizer(W.TRAIN_LR),
        params=host_init_decoder_params(CFG, W.CKPT_SEED), device="cpu")
    step = train.make_train_step(CFG, opt)
    for i in range(2):
        state, _ = step(state, *W.train_batch(i))
    TrainCheckpointer(str(root / "ck_whole")).save(state)
    return {k: v.detach().clone().numpy() for k, v in state["params"].items()}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The port's worlds of 2 and 4, started at once; the reference runs
    meanwhile.  The lost-rank world starts once both have ended."""
    root = tmp_path_factory.mktemp("ckpt_root")
    out = {"root": root, "whole": _one_device_save(root)}
    for n, scenarios in ((2, "lm_train,encoder_train,ckpt_save"),
                         (4, "lm_train,encoder_train,ckpt_restore")):
        d = tmp_path_factory.mktemp(f"train_world{n}")
        (d / "ckpt_root.txt").write_text(str(root))
        out[n] = W.World(n, scenarios, d)
    out["lost_dir"] = tmp_path_factory.mktemp("train_world_lost")
    yield out
    for key in (2, 4, "lost"):
        if key in out:
            out[key].close()


def _world(worlds, tag):
    return worlds[_world_of(tag)]


def _ranks(worlds, tag, name):
    w = _world(worlds, tag)
    return [w.result(name, r) for r in range(_world_of(tag))]


# ---- the LM step -------------------------------------------------------------

def _jstate(cfg, mesh=None, seed=W.TRAIN_SEED):
    host = host_init_decoder_params(DecoderConfig(**{**W.TRAIN_WIDTHS,
                                                     "vocab_size": cfg.vocab_size}), seed)
    return jtrain.init_train_state(
        jax.random.PRNGKey(0), cfg, jtrain.default_optimizer(W.TRAIN_LR), mesh=mesh,
        params={k: jnp.asarray(v) for k, v in host.items()})


def _jrun(mesh=None):
    """The reference's make_train_step over TRAIN_STEPS batches: losses,
    params after each step, and the global norm of each step's gradient
    on the tree it was taken at."""
    jstate, jopt = _jstate(JCFG, mesh)
    jstep = jtrain.make_train_step(JCFG, jopt, mesh=mesh)
    grad = jax.jit(jax.grad(jtrain.lm_loss), static_argnums=1)
    out = {"loss": [], "params": [], "norm": []}
    for i in range(W.TRAIN_STEPS):
        ids, lengths = (jnp.asarray(a) for a in W.train_batch(i))
        if mesh is None:
            out["norm"].append(float(optax.global_norm(
                grad(jstate["params"], JCFG, ids, lengths))))
        jstate, loss = jstep(jstate, ids, lengths)
        out["loss"].append(float(loss))
        out["params"].append({k: np.asarray(v) for k, v in jstate["params"].items()})
    return out


@pytest.fixture(scope="module")
def reference_lm():
    return {"single": _jrun(), "mesh8": _jrun(jmesh.host_cpu_mesh(8, data=2))}


@pytest.mark.parametrize("ref", ["single", "mesh8"])
@pytest.mark.parametrize("tag", SHAPES)
def test_lm_steps_equal_the_reference(worlds, reference_lm, tag, ref):
    """Each step's loss and the whole params after it against the
    reference's single-device step and its own step at (2, 4)."""
    want = reference_lm[ref]
    for res in _ranks(worlds, tag, f"lm_train_{tag}"):
        for i in range(W.TRAIN_STEPS):
            assert abs(float(res[f"loss{i}"]) - want["loss"][i]) <= TOL, (i, ref)
            for k, v in want["params"][i].items():
                adam_close(res[f"s{i}/p/{k}"], v, W.TRAIN_LR, i + 1,
                           f"{k} after step {i + 1} ({ref})")


@pytest.mark.parametrize("tag", SHAPES)
def test_replicated_leaves_agree_and_the_clip_takes_the_global_norm(
        worlds, reference_lm, tag):
    """Megatron's f makes every replicated leaf's gradient whole, so its
    gradient and value are bit-equal on every rank after each step; the
    clip's norm is the global gradient's on every rank."""
    runs = _ranks(worlds, tag, f"lm_train_{tag}")
    repl = [k for k in runs[0] if k.startswith("g0/")]
    assert sorted(k[3:] for k in repl) == sorted(
        ["tok_emb", "final_norm_g"] + [f"l{i}_{n}_norm_g" for i in range(CFG.num_layers)
                                       for n in ("attn", "mlp")])
    for i in range(W.TRAIN_STEPS):
        for res in runs[1:]:
            assert float(res[f"norm{i}"]) == float(runs[0][f"norm{i}"])
            for k in runs[0]:
                if k.startswith((f"g{i}/", f"local{i}/")):
                    np.testing.assert_array_equal(res[k], runs[0][k], err_msg=k)
        want = reference_lm["single"]["norm"][i]
        assert abs(float(runs[0][f"norm{i}"]) - want) <= NORM_RTOL * want, i


@pytest.mark.parametrize("tag", SHAPES)
def test_training_collective_budget(worlds, tag):
    """A step's collectives, L = 2 layers, remat on:
    * forward, 2L all-reduces (g after wo and w_down), and L more while
      remat recomputes the layers: the recompute stops once it has rebuilt
      what the backward saved (torch.utils.checkpoint's early stop), and
      nothing saved lies past a layer's last matmul input, so w_down's
      all-reduce is not issued again;
    * backward, 2L + 1 all-reduces of f (a layer's q/k/v and gate/up
      inputs, and lm_head's);
    * the vocabulary-parallel loss: the row max, then Σexp with the target
      logit (2);
    * the clip: one scalar over the model axis;
    * on a data axis > 1: one all-reduce a leaf and one of the loss.
    Nothing else, on every rank and at every step."""
    n_data, n_model = _shape(tag)
    L = CFG.num_layers
    want = {"all_reduce.decoder": 3 * L, "all_reduce.decoder_grad": 2 * L + 1,
            "all_reduce.vocab_ce": 2, "all_reduce.clip": 1}
    if n_data > 1:
        want.update({"all_reduce.lm_grads": N_LEAVES, "all_reduce.lm_loss": 1})
    for res in _ranks(worlds, tag, f"lm_train_{tag}"):
        for i in range(W.TRAIN_STEPS):
            assert _counts(res, f"s{i}/") == want, i


@pytest.mark.parametrize("tag", SHAPES)
def test_uneven_vocabulary_trains_as_one_device(worlds, tag):
    """A vocabulary the model axis does not divide (62: blocks of 16, 16,
    16 and 14 at n = 4): the last rank's lm_head block is shorter, its
    vocabulary-parallel loss offsets the targets by the block's start; one
    step against the reference's single-device step."""
    cfg = JDecoderConfig(**{**W.TRAIN_WIDTHS, "vocab_size": W.TRAIN_UNEVEN_VOCAB})
    jstate, jopt = _jstate(cfg)
    ids, lengths = W.train_batch(0, W.TRAIN_UNEVEN_VOCAB)
    jstate, jloss = jtrain.make_train_step(cfg, jopt)(jstate, jnp.asarray(ids),
                                                      jnp.asarray(lengths))
    for res in _ranks(worlds, tag, f"lm_train_{tag}"):
        assert abs(float(res["uneven/loss"]) - float(jloss)) <= TOL
        for k, v in jstate["params"].items():
            adam_close(res[f"uneven/p/{k}"], np.asarray(v), W.TRAIN_LR, 1, k)


@pytest.mark.parametrize("tag", SHAPES)
def test_a_step_refuses_a_tree_or_batch_that_does_not_fit(worlds, tag):
    """A whole tree on a tensor-parallel mesh and a shard on the mesh-less
    step raise ValueError naming the leaf; rows that do not divide the
    data axis raise too."""
    for res in _ranks(worlds, tag, f"lm_train_{tag}"):
        whole_on_mesh, shard_alone, rows = res["refused"].tolist()
        assert "leaf 'lm_head'" in whole_on_mesh and "this rank's block" in whole_on_mesh
        assert "leaf 'lm_head'" in shard_alone and "make_train_step(mesh=)" in shard_alone
        if _shape(tag)[0] > 1:
            assert "not divisible by data=2" in rows
        else:
            assert rows == ""


# ---- the (1, 1) mesh and wrong trees, in this process ------------------------------

def test_the_1x1_mesh_is_the_single_device_step():
    """make_mesh without a process group is (1, 1): the LM and encoder
    steps on it are the mesh-less steps bit for bit and issue nothing; the
    state keeps its tensors (the step updates them in place)."""
    mesh = tmesh.make_mesh(device="cpu")
    host = host_init_decoder_params(CFG, 1)
    runs = []
    for m in (None, mesh):
        state, opt = train.init_train_state(CFG, optimizer=train.default_optimizer(1e-2),
                                            params=host, device="cpu", mesh=m)
        ptrs = {k: v.data_ptr() for k, v in state["params"].items()}
        step = train.make_train_step(CFG, opt, m)
        tmesh.COLLECTIVES.clear()
        losses = [float(step(state, *W.train_batch(i))[1]) for i in range(2)]
        assert not tmesh.COLLECTIVES
        assert {k: v.data_ptr() for k, v in state["params"].items()} == ptrs
        runs.append((losses, state["params"]))
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][k], v, rtol=0, atol=0)
    enc = []
    for m in (None, mesh):
        state, opt = encoder.init_encoder_train_state(
            ENC_CFG, params=host_init_encoder_params(ENC_CFG, 1), device="cpu", mesh=m)
        step = encoder.make_encoder_train_step(ENC_CFG, opt, m)
        tmesh.COLLECTIVES.clear()
        losses = [float(step(state, *W.enc_train_batch(i, ENC_CFG))[1]) for i in range(2)]
        assert not tmesh.COLLECTIVES
        enc.append((losses, state["params"]))
    assert enc[0][0] == enc[1][0]
    for k, v in enc[0][1].items():
        torch.testing.assert_close(enc[1][1][k], v, rtol=0, atol=0)


# ---- the encoder ---------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_encoder():
    jcfg = JEncoderConfig(**W.ENC_WIDTHS)
    host = host_init_encoder_params(ENC_CFG, 1)
    jstate, jopt = jenc.init_encoder_train_state(
        jax.random.PRNGKey(0), jcfg, params={k: jnp.asarray(v) for k, v in host.items()})
    jstep = jenc.make_encoder_train_step(jcfg, jopt)
    grad = jax.jit(jax.grad(jenc.info_nce_loss), static_argnums=1)
    out = {"loss": [], "params": [], "near_eps": []}
    near = {k: np.zeros(v.shape, bool) for k, v in host.items()}
    for i in range(W.ENC_TRAIN_STEPS):
        batch = [jnp.asarray(a) for a in W.enc_train_batch(i, ENC_CFG)]
        for k, g in grad(jstate["params"], jcfg, *batch).items():
            near[k] = near[k] | (np.abs(np.asarray(g)) < NEAR_EPS)
        jstate, loss = jstep(jstate, *batch)
        out["loss"].append(float(loss))
        out["params"].append({k: np.asarray(v) for k, v in jstate["params"].items()})
        out["near_eps"].append({k: v.copy() for k, v in near.items()})
    return out


@pytest.mark.parametrize("after", [1, 3])
@pytest.mark.parametrize("tag", ENC_SHAPES)
def test_encoder_dp_equals_the_reference(worlds, reference_encoder, tag, after):
    """Losses up to and params after one and after three data-parallel
    steps against the reference's single-device step."""
    for res in _ranks(worlds, tag, f"encoder_train_{tag}"):
        for i in range(after):
            assert abs(float(res[f"loss{i}"]) - reference_encoder["loss"][i]) <= ENC_TOL, i
        near = reference_encoder["near_eps"][after - 1]
        for k, v in reference_encoder["params"][after - 1].items():
            diff = np.abs(res[f"s{after - 1}/p/{k}"] - v)
            assert diff[~near[k]].max(initial=0) <= ENC_TOL, (k, after)
            assert diff.max() <= 2e-4 * after, (k, after)


@pytest.mark.parametrize("tag", ENC_SHAPES)
def test_encoder_dp_collectives_and_refusals(worlds, tag):
    """A step gathers zq and zp over the data axis (two all-gathers, and
    their gradients' two all-reduces), reduces one all-reduce a leaf and
    one of the loss; train_encoder(mesh=) rounds a batch of 5 up to the
    data axis; 7 rows on it raise."""
    n_data = _shape(tag)[0]
    n_leaves = len(host_init_encoder_params(ENC_CFG, 1))
    want = {"all_gather.encoder_negatives": 2, "all_reduce.encoder_negatives_grad": 2,
            "all_reduce.encoder_grads": n_leaves, "all_reduce.encoder_loss": 1}
    for res in _ranks(worlds, tag, f"encoder_train_{tag}"):
        for i in range(W.ENC_TRAIN_STEPS):
            assert _counts(res, f"s{i}/") == want, i
        assert f"not divisible by data={n_data}" in str(res["refused"])
        assert res["rounded"].tolist() == [-(-5 // n_data) * n_data]


@pytest.mark.parametrize("tag", ENC_SHAPES)
def test_a_dp_encoder_checkpoint_is_written_once_and_restores_bitwise(worlds, tag):
    """Every rank saves the replicated encoder state into one directory:
    each writes its own file (rank 0's holds the leaves, one barrier
    triple), the restore into another tree on the mesh gives the params,
    moments, step and count bitwise and the same next loss, and a
    one-device restore gives the saved leaves bitwise."""
    n = _world_of(tag)
    ck_dir = worlds["root"] / f"enc_{tag}"
    results = _ranks(worlds, tag, f"encoder_train_{tag}")
    steps = W.ENC_TRAIN_STEPS
    assert sorted(os.listdir(ck_dir / str(steps))) == [f"rank{r}-of-{n}.pt" for r in range(n)]
    saved = results[0]
    keys = [k[len("saved/"):] for k in saved if k.startswith("saved/")]
    assert len(keys) == 3 * len(host_init_encoder_params(ENC_CFG, 1))
    for res in results:
        assert _counts(res, "save/") == {"barrier.checkpoint": 3}
        assert res["restored/step"].tolist() == [steps, steps]
        for k in keys:
            np.testing.assert_array_equal(res[f"restored/{k}"], saved[f"saved/{k}"], err_msg=k)
            np.testing.assert_array_equal(res[f"saved/{k}"], saved[f"saved/{k}"], err_msg=k)
        assert float(res["restored/next"]) == float(res["next"])
    state, _ = encoder.init_encoder_train_state(
        ENC_CFG, params=host_init_encoder_params(ENC_CFG, 2), device="cpu")
    TrainCheckpointer(str(ck_dir)).restore(state)
    assert state["step"] == steps and state["opt_state"].count == steps
    moments = state["opt_state"].adamw.state
    for k, p in state["params"].items():
        np.testing.assert_array_equal(p.detach().numpy(), saved[f"saved/p/{k}"], err_msg=k)
        np.testing.assert_array_equal(moments[p]["exp_avg"].numpy(), saved[f"saved/m1/{k}"])
        np.testing.assert_array_equal(moments[p]["exp_avg_sq"].numpy(), saved[f"saved/m2/{k}"])


# ---- checkpoints across meshes ---------------------------------------------------

def _saved(worlds):
    return worlds[2].result("ckpt_save", 0)


def _same_state(got, got_prefix, want, want_prefix="saved/"):
    keys = [k for k in want if k.startswith(want_prefix)]
    assert len(keys) == 3 * N_LEAVES
    for k in keys:
        np.testing.assert_array_equal(got[got_prefix + k[len(want_prefix):]], want[k],
                                      err_msg=k)


@pytest.mark.parametrize("tag", ["1x4", "2x2"])
def test_a_1x2_checkpoint_restores_bitwise_on_another_mesh(worlds, tag):
    """Saved at (1, 2) after two steps: restored into another tree at (1, 4)
    and (2, 2), the params, both moments, step and count are the saved
    ones; two more steps give the uninterrupted run's losses."""
    saved = _saved(worlds)
    assert int(saved["saved_step"]) == 2
    for r in range(4):
        res = worlds[4].result("ckpt_restore", r)
        assert res[f"{tag}/step"].tolist() == [2, 2]
        _same_state(res, f"{tag}/", saved)
        np.testing.assert_allclose(res[f"{tag}/resumed"], saved["straight"], rtol=0, atol=TOL)


def test_a_2x2_checkpoint_restores_at_1x2_and_resumes_bitwise(worlds):
    """(2, 2) saves what it restored (every rank's file, one barrier
    triple); back at (1, 2) the state is the saved one and the run resumes
    bit for bit."""
    for r in range(4):
        assert _counts(worlds[4].result("ckpt_restore", r), "save/") == {
            "barrier.checkpoint": 3}
    names = sorted(os.listdir(worlds["root"] / "ck_2x2" / "2"))
    assert names == [f"rank{r}-of-4.pt" for r in range(4)]
    saved = _saved(worlds)
    for r in range(2):
        res = worlds[2].result("ckpt_save", r)
        assert res["ck_2x2/step"].tolist() == [2, 2]
        _same_state(res, "ck_2x2/", saved)
        np.testing.assert_array_equal(res["ck_2x2/resumed"], saved["straight"])


def test_a_one_device_checkpoint_restores_on_a_mesh_and_back(worlds):
    """A mesh-less save (state.pt) restored at (1, 2) gives the one-device
    params and resumes within the LM tolerance; the (1, 2) save restored
    into a mesh-less state gives the saved params and moments bitwise and
    resumes within it too."""
    saved = _saved(worlds)
    res = worlds[2].result("ckpt_save", 0)
    assert res["ck_whole/step"].tolist() == [2, 2]
    for k, v in worlds["whole"].items():
        np.testing.assert_array_equal(res[f"ck_whole/p/{k}"], v, err_msg=k)
    np.testing.assert_allclose(res["ck_whole/resumed"], saved["straight"], rtol=0, atol=TOL)
    state, opt = train.init_train_state(
        CFG, optimizer=train.default_optimizer(W.TRAIN_LR),
        params=host_init_decoder_params(CFG, W.CKPT_TEMPLATE_SEED), device="cpu")
    TrainCheckpointer(str(worlds["root"] / "ck_1x2")).restore(state)
    assert state["step"] == 2 and state["opt_state"].count == 2
    moments = state["opt_state"].adamw.state
    for k, p in state["params"].items():
        np.testing.assert_array_equal(p.detach().numpy(), saved[f"saved/p/{k}"])
        np.testing.assert_array_equal(moments[p]["exp_avg"].numpy(), saved[f"saved/m1/{k}"])
        np.testing.assert_array_equal(moments[p]["exp_avg_sq"].numpy(), saved[f"saved/m2/{k}"])
    step = train.make_train_step(CFG, opt)
    losses = [float(step(state, *W.train_batch(i))[1]) for i in (2, 3)]
    np.testing.assert_allclose(losses, saved["straight"], rtol=0, atol=TOL)


def test_a_missing_rank_file_is_neither_named_nor_restored(worlds, tmp_path):
    _saved(worlds)
    shutil.copytree(worlds["root"] / "ck_1x2" / "2", tmp_path / "ck" / "2")
    os.remove(tmp_path / "ck" / "2" / "rank1-of-2.pt")
    ck = TrainCheckpointer(str(tmp_path / "ck"))
    assert ck.latest_step() is None
    state, _ = train.init_train_state(CFG, params=host_init_decoder_params(CFG, 0),
                                      device="cpu")
    with pytest.raises(FileNotFoundError, match="rank 1"):
        ck.restore(state, step=2)


def test_a_manifest_of_other_global_shapes_raises(worlds):
    _saved(worlds)
    cfg = DecoderConfig(**{**W.TRAIN_WIDTHS, "vocab_size": 96})
    state, _ = train.init_train_state(cfg, params=host_init_decoder_params(cfg, 0),
                                      device="cpu")
    with pytest.raises(ValueError, match="global shape"):
        TrainCheckpointer(str(worlds["root"] / "ck_1x2")).restore(state)


# ---- a lost peer ------------------------------------------------------------------

def test_a_lost_peer_fails_the_step_with_a_mesh_fault(worlds):
    """(1, 2): rank 1 dies after a step; rank 0's next step raises
    MeshFault within the process group's timeout."""
    worlds[2].join()
    worlds[4].join()
    w = worlds["lost"] = W.World(2, "train_lost_rank", worlds["lost_dir"],
                                 timeout_s=LOST_TIMEOUT_S)
    rcs = w.join()
    assert rcs[0] == 0, w.stderr()
    assert rcs[1] not in (0, None), w.stderr()
    with np.load(os.path.join(w.out, "train_lost_rank.r0.npz")) as d:
        assert str(d["kind"]) == "MeshFault", str(d["message"])
        assert float(d["seconds"]) < LOST_TIMEOUT_S + 5
