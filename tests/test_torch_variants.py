"""The port's trainer variants (``models.heads``, ``training.variants``)
against ``evr_tpu`` on the CPU.

Same seeded numpy CLIP params (W 128, two heads of 64; four blocks a tower
for the progressive trainer, so phases 2 and 3 split the blocks into early
and late, two for the others), same numpy batches;
each JAX trainer's initial heads are carried across with
``params_from_numpy``, and the progressive trainer's dropout keep-masks
(``jax.random.bernoulli`` under the step's key) are handed to the port's
``heads._keep_mask``. Each JAX trainer runs once, in a module-scoped fixture.
Tolerances: losses and each trainable leaf's update 5e-3 relative (the
update's L2 error against its norm), gradients of the losses 5e-3 relative;
the first step of each progressive phase (rate 0) leaves every param
bit-equal in both packages; the schedules and the clip-then-AdamW chain
within 1e-6 of optax's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.models.clip import CLIPConfig as JCLIPConfig
from evr_tpu.models.clip import TextConfig as JTextConfig
from evr_tpu.models.clip import VisionConfig as JVisionConfig
from evr_tpu.models import heads as jheads
from evr_tpu.training import variants as jv
from evr_tpu_torch.models import heads as theads
from evr_tpu_torch.models.clip import CLIPConfig, TextConfig, VisionConfig, init_clip_params
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.training import variants as tv
from evr_tpu_torch.training.finetune import flat_leaves
from evr_tpu_torch.training.partition import map_with_paths
from torch_threads import one_torch_thread  # noqa: F401

TOL = 5e-3
STEPS = 2  # steps per progressive phase


def cfgs(layers: int = 4, width: int = 128):
    """(JAX, port) configurations of one geometry: two heads of width / 2."""
    kw = dict(embed_dim=32)
    vis = dict(image_size=32, patch_size=8, width=width, layers=layers, heads=2)
    txt = dict(context_length=16, vocab_size=600, width=width, layers=layers, heads=2)
    return (JCLIPConfig(vision=JVisionConfig(**vis), text=JTextConfig(**txt), **kw),
            CLIPConfig(vision=VisionConfig(**vis), text=TextConfig(**txt), **kw))


def tiny_batch(rng, n=8):
    tokens = np.zeros((n, 16), np.int32)
    for i in range(n):
        ln = int(rng.integers(3, 10))
        tokens[i, :ln] = rng.integers(1, 500, size=ln)
        tokens[i, ln] = 599
    return {
        "images": (rng.random((n, 32, 32, 3)) * 255).astype(np.uint8),
        "tokens": tokens,
        "labels": rng.integers(0, 3, size=n).astype(np.int32),
    }


def _np(tree):
    return {k: (v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).copy()
            for k, v in flat_leaves(tree).items()}


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _without_key_bias(key, x):
    """The attention's key bias gets a gradient of exactly zero in exact
    arithmetic (softmax ignores a shift shared by every key of a query), so
    each package's Adam update of it is its own rounding noise normalised:
    the query and value thirds of ``qkv/bias`` are compared, the key third
    is held to zero gradient in ``test_progressive_phase_matches_jax``."""
    if not key.endswith("attn/qkv/bias"):
        return x
    w = x.shape[0] // 3
    return np.concatenate([x[:w], x[2 * w:]])


def _assert_updates_close(before_t, after_t, before_j, after_j, what):
    """Every leaf's update within TOL of JAX's (relative L2); a leaf JAX
    leaves alone is bit-unchanged in the port. Returns the leaves moved."""
    moved = 0
    for k in before_t:
        dj = _without_key_bias(k, after_j[k] - before_j[k])
        dt = _without_key_bias(k, after_t[k] - before_t[k])
        if not dj.any():
            np.testing.assert_array_equal(after_t[k], before_t[k], err_msg=f"{what}: {k}")
            continue
        moved += 1
        err = np.linalg.norm(dt - dj)
        assert err <= TOL * np.linalg.norm(dj), (what, k, err, np.linalg.norm(dj))
    return moved


# -- losses ------------------------------------------------------------------


def test_multimodal_loss_and_its_gradients_match_jax():
    rng = np.random.default_rng(0)
    n, d, c = 6, 32, 3
    heads_np = jax.tree.map(np.asarray, jheads.init_fusion_params(
        jax.random.PRNGKey(0), jheads.FusionConfig(d, num_classes=c)))
    img, txt = _unit(rng, n, d), _unit(rng, n, d)
    labels = rng.integers(0, c, size=n)
    kw = dict(label_smoothing=0.1, entropy_weight=0.01, weight_decay=1e-4)

    def jloss(h, i, t):
        out = jheads.fusion_forward(h, jheads.FusionConfig(d, num_classes=c), i, t)
        return jv.multimodal_loss(out, jnp.asarray(labels), trainable_params=h, **kw)

    (jval, jmet), jgrads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        jax.tree.map(jnp.asarray, heads_np), jnp.asarray(img), jnp.asarray(txt))
    heads = params_from_numpy(heads_np)
    leaves = flat_leaves(heads)
    ti, tt = torch.tensor(img, requires_grad=True), torch.tensor(txt, requires_grad=True)
    for v in leaves.values():
        v.requires_grad_(True)
    out = theads.fusion_forward(heads, theads.FusionConfig(d, num_classes=c), ti, tt)
    tval, tmet = tv.multimodal_loss(out, torch.from_numpy(labels), trainable_params=heads, **kw)
    tval.backward()
    assert set(tmet) == set(jmet) and {"fusion_entropy", "l2"} <= set(tmet)
    for k in jmet:
        np.testing.assert_allclose(tmet[k].item(), float(jmet[k]), rtol=1e-5, err_msg=k)
    ref = {**{f"heads/{k}": v for k, v in _np(jgrads[0]).items()}, "img": np.asarray(jgrads[1]),
           "txt": np.asarray(jgrads[2])}
    got = {**{f"heads/{k}": v.grad.numpy() for k, v in leaves.items()}, "img": ti.grad.numpy(),
           "txt": tt.grad.numpy()}
    for k, r in ref.items():
        assert np.linalg.norm(got[k] - r) <= TOL * np.linalg.norm(r), k


def test_hard_negatives_with_ties_and_their_loss_match_jax():
    rng = np.random.default_rng(1)
    sims = rng.standard_normal((8, 8)).astype(np.float32)
    sims[:, 5] = sims[:, 2]  # exact ties: the lower index first
    sims[:, 7] = sims[:, 2]
    got = tv.mine_hard_negatives(torch.from_numpy(sims), k=4).numpy()
    np.testing.assert_array_equal(got, np.asarray(jv.mine_hard_negatives(jnp.asarray(sims), k=4)))
    img, txt = _unit(rng, 8, 16), _unit(rng, 8, 16)
    txt[3] = txt[1]  # tied negatives inside the loss
    scale = np.float32(np.log(1 / 0.07))
    for hw in (1.0, 2.0):
        j = float(jv.hard_negative_infonce(jnp.asarray(img), jnp.asarray(txt), jnp.asarray(scale),
                                           hard_weight=hw))
        t = tv.hard_negative_infonce(torch.from_numpy(img), torch.from_numpy(txt),
                                     torch.tensor(scale), hard_weight=hw).item()
        np.testing.assert_allclose(t, j, rtol=1e-5)


def test_concept_vocab_and_targets_match_jax():
    caps = ["a man fighting in the street", "the man holds a red umbrella",
            "a dog running in the street", "Two MEN, one dog; a knife!"]
    for size, min_count in ((10, 1), (3, 1), (10, 2)):
        vocab = tv.build_concept_vocab(caps, size=size, min_count=min_count)
        assert vocab == jv.build_concept_vocab(caps, size=size, min_count=min_count)
        np.testing.assert_array_equal(tv.concept_targets(caps, vocab), jv.concept_targets(caps, vocab))


# -- the optimizers ------------------------------------------------------------


def test_schedule_and_clip_over_frozen_leaves_match_optax():
    """optax's warmup cosine at every count of a phase; then two updates of
    the phase-1 chain from synthetic gradients whose frozen leaves dominate
    the global norm at the first step: the port clips them as optax does
    (with the frozen leaves in the norm), and zeroing the frozen gradients
    changes the heads' update, so the check can tell."""
    import optax

    for peak, warm, decay in ((1e-4, 1, 2), (3e-5, 10, 100), (1e-5, 2, 9)):
        ref = np.asarray(optax.warmup_cosine_decay_schedule(0.0, peak, warm, decay)(
            jnp.arange(decay + 2, dtype=jnp.int32)))
        fn = tv.warmup_cosine_decay(peak, warm, decay)
        got = np.asarray([fn(count).item() for count in range(decay + 2)], np.float32)
        np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0, err_msg=f"{peak} {warm} {decay}")
        assert got[0] == 0.0

    jcfg, tcfg = cfgs(layers=1, width=64)  # one block a tower: the chain's leaves, few of them
    np_params = init_clip_params(3, tcfg)
    jtr = jv.ProgressiveTrainer(jcfg, np_params, jv.ProgressiveTrainConfig(steps_per_phase=4))
    rng = np.random.default_rng(2)
    shapes = {k: v.shape for k, v in _np(jtr.params).items()}

    def grads_at(step, frozen_scale):
        return {k: np.asarray(rng.standard_normal(s) * (1.0 if k.startswith("heads") else frozen_scale), np.float32)
                for k, s in shapes.items()}

    g = [grads_at(0, 1e4), grads_at(1, 0.0)]

    def run_port(grads):
        ttr = tv.ProgressiveTrainer(tcfg, np_params, tv.ProgressiveTrainConfig(steps_per_phase=4),
                                    device="cpu")
        ttr.params["heads"] = params_from_numpy(jax.tree.map(np.asarray, jtr.params["heads"]))
        for gs in grads:
            ttr.optimizer.apply(ttr.params, {k: torch.as_tensor(v) for k, v in gs.items()}, ttr.opt_state)
        return _np(ttr.params)

    def tree_of(flat):
        return map_with_paths(jtr.params, lambda path, _: jnp.asarray(flat["/".join(path)]))

    @jax.jit
    def jstep(grads, state, params):
        upd, state = jtr.optimizer.update(grads, state, params)
        return optax.apply_updates(params, upd), state

    before = _np(jtr.params)
    params, state = jtr.params, jtr.opt_state
    for gs in g:
        params, state = jstep(tree_of(gs), state, params)
    ref = _np(params)
    got = run_port(g)
    for k in shapes:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-9, err_msg=k)
        if not k.startswith("heads"):
            np.testing.assert_array_equal(got[k], before[k])
    heads_only = run_port([{k: (v if k.startswith("heads") else 0 * v) for k, v in gs.items()} for gs in g])
    k = "heads/fusion/kernel"
    assert np.linalg.norm(heads_only[k] - got[k]) > 0.1 * np.linalg.norm(got[k] - before[k])


# -- the trainers ------------------------------------------------------------


@pytest.fixture(scope="module")
def progressive():
    """Three phases of STEPS steps each through both packages: per phase and
    step, (port params before, after, JAX params before, after, JAX
    metrics, port metrics), and both trainers' labels per phase."""
    jcfg, tcfg = cfgs()
    np_params = init_clip_params(1, tcfg)
    rng = np.random.default_rng(5)
    batches = [tiny_batch(rng) for _ in range(3 * STEPS)]
    pcfg = dict(steps_per_phase=STEPS)
    jtr = jv.ProgressiveTrainer(jcfg, jax.tree.map(jnp.asarray, np_params), jv.ProgressiveTrainConfig(**pcfg))
    ttr = tv.ProgressiveTrainer(tcfg, np_params, tv.ProgressiveTrainConfig(**pcfg), device="cpu")
    ttr.params["heads"] = params_from_numpy(jax.tree.map(np.asarray, jtr.params["heads"]))
    hidden = jheads.FusionConfig().hidden_dim
    masks = [np.asarray(jax.random.bernoulli(jax.random.PRNGKey(i), 0.9, (8, hidden)))
             for i in range(3 * STEPS)]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(theads, "_keep_mask",
                   lambda shape, keep, gen, dev: torch.tensor(masks[len(ttr.history)]))
        for phase in (1, 2, 3):
            if phase > 1:
                jtr.next_phase()
                ttr.next_phase()
            rows = []
            for s in range(STEPS):
                b = batches[(phase - 1) * STEPS + s]
                before_t, before_j = _np(ttr.params), _np(jtr.params)
                jm = jtr.train_step(b)
                tm = ttr.train_step(b)
                rows.append((before_t, _np(ttr.params), before_j, _np(jtr.params), jm, tm))
            out[phase] = {"steps": rows, "labels": (jtr.labels_for_phase(phase), ttr.labels_for_phase(phase))}
    out["trainers"] = (jtr, ttr)
    return out


@pytest.mark.parametrize("phase", [1, 2, 3])
def test_progressive_phase_matches_jax(progressive, phase):
    jlabels, tlabels = progressive[phase]["labels"]
    assert tlabels == jlabels
    rows = progressive[phase]["steps"]
    for s, (before_t, after_t, before_j, after_j, jm, tm) in enumerate(rows):
        assert tm["phase"] == jm["phase"] == phase
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=TOL, err_msg=f"phase {phase} step {s}: {k}")
        if s == 0:  # the schedule's rate is 0: nothing moves, in either package
            for k in before_t:
                np.testing.assert_array_equal(after_t[k], before_t[k], err_msg=k)
                np.testing.assert_array_equal(after_j[k], before_j[k], err_msg=k)
            continue
        moved = _assert_updates_close(before_t, after_t, before_j, after_j, f"phase {phase} step {s}")
        labels = flat_leaves(tlabels)
        assert moved == sum(1 for v in labels.values() if v != "frozen")
    if phase == 3:
        jtr, ttr = progressive["trainers"]
        with pytest.raises(ValueError, match="cross-phase"):
            ttr._enter_phase(2)
        # the key bias's gradient is rounding noise (``_without_key_bias``)
        _, grads = ttr.gradients(tiny_batch(np.random.default_rng(6)))
        for k, g in grads.items():
            if k.endswith("attn/qkv/bias"):
                w = g.shape[0] // 3
                assert g[w:2 * w].norm() <= 1e-5 * g[2 * w:].norm(), k
        assert {v for v in flat_leaves(tlabels).values()} == {"head", "late", "mid", "early"}


def test_projection_trainer_matches_jax():
    jcfg, tcfg = cfgs(layers=2)
    np_params = init_clip_params(2, tcfg)
    rng = np.random.default_rng(7)
    batches = [tiny_batch(rng) for _ in range(2)]
    kw = dict(proj_dim=16, lr=1e-3, compute_dtype="float32", num_classes=3)
    jtr = jv.ProjectionTrainer(jcfg, jax.tree.map(jnp.asarray, np_params), jv.ProjectionTrainConfig(**kw))
    ttr = tv.ProjectionTrainer(tcfg, np_params, tv.ProjectionTrainConfig(**kw), device="cpu")
    ttr.params["heads"] = params_from_numpy(jax.tree.map(np.asarray, jtr.params["heads"]))
    clip_before = _np(ttr.params["clip"])
    for b in batches:
        before_t, before_j = _np(ttr.params["heads"]), _np(jtr.params["heads"])
        jm, tm = jtr.train_step(b), ttr.train_step(b)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=TOL, err_msg=k)
        moved = _assert_updates_close(before_t, _np(ttr.params["heads"]), before_j,
                                      _np(jtr.params["heads"]), "heads")
        assert moved == len(before_t)
    for k, v in _np(ttr.params["clip"]).items():
        np.testing.assert_array_equal(v, clip_before[k], err_msg=k)  # CLIP frozen
    img_t, txt_t = ttr.encode_projected(batches[0]["images"], batches[0]["tokens"])
    img_j, txt_j = jtr.encode_projected(batches[0]["images"], batches[0]["tokens"])
    np.testing.assert_allclose(img_t, img_j, atol=1e-5)
    np.testing.assert_allclose(txt_t, txt_j, atol=1e-5)
    assert ttr.encode_projected(tokens=batches[0]["tokens"])[0] is None


def test_catlip_trainer_matches_jax():
    jcfg, tcfg = cfgs(layers=2)
    np_params = init_clip_params(4, tcfg)
    caps = ["a man fighting", "a dog running", "a red car", "people on stage"] * 2
    vocab = tv.build_concept_vocab(caps, size=16, min_count=1)
    batch = {"images": tiny_batch(np.random.default_rng(8))["images"],
             "targets": tv.concept_targets(caps, vocab)}
    kw = dict(lr=1e-3, compute_dtype="float32")
    jtr = jv.CatLIPTrainer(jcfg, jax.tree.map(jnp.asarray, np_params), vocab, jv.CatLIPTrainConfig(**kw))
    ttr = tv.CatLIPTrainer(tcfg, np_params, vocab, tv.CatLIPTrainConfig(**kw), device="cpu")
    ttr.params["head"] = params_from_numpy(jax.tree.map(np.asarray, jtr.params["head"]))
    text_before = _np(ttr.params["clip"]["text"])
    for _ in range(2):
        before_t, before_j = _np(ttr.params), _np(jtr.params)
        jm, tm = jtr.train_step(batch), ttr.train_step(batch)
        np.testing.assert_allclose(tm["bce_loss"], jm["bce_loss"], rtol=TOL)
        moved = _assert_updates_close(before_t, _np(ttr.params), before_j, _np(jtr.params), "catlip")
        assert moved == len(flat_leaves(ttr.params["clip"]["visual"])) + 2
    for k, v in _np(ttr.clip_params()["text"]).items():
        np.testing.assert_array_equal(v, text_before[k], err_msg=k)  # never run, never updated


@pytest.mark.parametrize("kw,item", [
    (dict(slots=4), "mesh"),
])
def test_unported_levers_are_refused(kw, item):
    """No projection-trainer lever is refused any more: the mesh, refused
    until it was ported, splits the tower encodes over its slots, and a step
    over 4 CPU slots matches the JAX trainer's (which takes a mesh too)."""
    from evr_tpu.parallel import get_mesh as jget_mesh
    from evr_tpu_torch.parallel import get_mesh

    jcfg, tcfg = cfgs(layers=2)
    np_params = init_clip_params(2, tcfg)
    batch = tiny_batch(np.random.default_rng(9))
    cfg_kw = dict(proj_dim=16, lr=1e-3, compute_dtype="float32")
    jtr = jv.ProjectionTrainer(jcfg, jax.tree.map(jnp.asarray, np_params), jv.ProjectionTrainConfig(**cfg_kw),
                               mesh=jget_mesh())
    ttr = tv.ProjectionTrainer(tcfg, np_params, tv.ProjectionTrainConfig(**cfg_kw),
                               **{item: get_mesh(kw["slots"], device="cpu")})
    assert ttr.device.type == "cpu" and ttr.mesh.size == kw["slots"]
    ttr.params["heads"] = params_from_numpy(jax.tree.map(np.asarray, jtr.params["heads"]))
    before_t, before_j = _np(ttr.params["heads"]), _np(jtr.params["heads"])
    jm, tm = jtr.train_step(batch), ttr.train_step(batch)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=TOL, err_msg=k)
    _assert_updates_close(before_t, _np(ttr.params["heads"]), before_j, _np(jtr.params["heads"]), "heads")
    img_t, _ = ttr.encode_projected(batch["images"])
    img_j, _ = jtr.encode_projected(batch["images"])
    np.testing.assert_allclose(img_t, img_j, atol=1e-5)
