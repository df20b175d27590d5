"""Shared inputs and checks of the trainer-lever tests
(``tests/test_torch_{lora,muon,gradcache,patch_drop,levers}.py``).

One tiny geometry in both packages (``tests/test_training.py``'s
``tiny_cfg``: 32 px images of 16 patches, T 17, W 64, four heads, two blocks
a tower), seeded numpy params and batches handed to both, classifier
dropout 0 (a ``torch.Generator`` cannot draw JAX's masks). JAX's gradients
are read without a second implementation: ``jax_gradients`` runs the JAX
package's own ``make_train_step`` with an optax transformation that stores
the gradients it is handed as its state.
"""

import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp
import optax

from evr_tpu.models import ClassifierConfig as JClassifierConfig
from evr_tpu.models.clip import CLIPConfig as JCLIPConfig
from evr_tpu.models.clip import TextConfig as JTextConfig
from evr_tpu.models.clip import VisionConfig as JVisionConfig
from evr_tpu.training import TrainConfig as JTrainConfig
from evr_tpu.training import make_optimizer as j_make_optimizer
from evr_tpu.training import make_train_step as j_make_train_step
from evr_tpu.training.finetune import TrainState as JTrainState
from evr_tpu_torch.models.classifier import ClassifierConfig, init_classifier_params
from evr_tpu_torch.models.clip import CLIPConfig, TextConfig, VisionConfig, init_clip_params
from evr_tpu_torch.models.convert import params_from_numpy
from evr_tpu_torch.training import TrainConfig, TrainState, make_grad_fn, make_optimizer, make_train_step
from evr_tpu_torch.training.finetune import flat_leaves
from evr_tpu_torch.training.partition import map_with_paths

TOL = 5e-3  # trainer gradients and updates, relative L2
VIS = dict(image_size=32, patch_size=8, width=64, layers=2, heads=4)
TXT = dict(context_length=16, vocab_size=600, width=64, layers=2, heads=4)


def cfgs(attn_impl: str = "plain", **kw):
    """(JAX, port) model configurations of the tiny geometry. The port's
    ``attn_impl="plain"`` runs each block through ``FusedBlockFunction``
    with the kernels' plain versions, the route of the card's kernels."""
    return (JCLIPConfig(embed_dim=32, vision=JVisionConfig(**VIS), text=JTextConfig(**TXT)),
            CLIPConfig(embed_dim=32, vision=VisionConfig(**VIS), text=TextConfig(**TXT), attn_impl=attn_impl, **kw))


JCLS = JClassifierConfig(embed_dim=32, num_classes=3, dropout=0.0)
TCLS = ClassifierConfig(embed_dim=32, num_classes=3, dropout=0.0)


def np_params(seed: int = 0, classifier: bool = True) -> dict:
    params = {"clip": init_clip_params(seed, cfgs()[1])}
    if classifier:
        params["classifier"] = init_classifier_params(seed + 1, TCLS)
    return params


def tiny_batch(rng, n=8):
    tokens = np.zeros((n, 16), np.int32)
    for i in range(n):
        ln = int(rng.integers(3, 10))
        tokens[i, :ln] = rng.integers(1, 500, size=ln)
        tokens[i, ln] = 599  # EOT = max id
    return {
        "images": (rng.random((n, 32, 32, 3)) * 255).astype(np.uint8),
        "tokens": tokens,
        "labels": rng.integers(0, 3, size=n).astype(np.int32),
    }


def to_np(tree) -> dict:
    """Flat {path key: numpy copy} of a tree of tensors or JAX arrays."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)).copy()
            for k, v in flat_leaves(tree).items()}


def _capture():
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


@functools.lru_cache(maxsize=None)
def _capturing_step(tc_items: tuple, jcfg):
    """One jitted JAX step a configuration, its optimizer the capture (the
    compile is reused by every call with the same shapes)."""
    capture = _capture()
    return j_make_train_step(jcfg, JCLS, JTrainConfig(**dict(tc_items)), capture)[0], capture


def jax_gradients(tc_kw: dict, params: dict, batch: dict, key=0, jcfg=None):
    """(metrics, flat gradients) of one JAX ``make_train_step`` call at
    ``params`` (numpy tree), read from a capturing optimizer's state."""
    step, capture = _capturing_step(tuple(sorted(tc_kw.items())), jcfg or cfgs()[0])
    p = jax.tree.map(jnp.asarray, params)
    state = JTrainState(params=p, opt_state=capture.init(p), step=jnp.zeros((), jnp.int32))
    state, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(key))
    return {k: float(v) for k, v in metrics.items()}, to_np(state.opt_state)


def port_gradients(tc_kw: dict, params: dict, batch: dict, generator=None, tcfg=None):
    """(metrics, flat gradients of the trainable leaves) of the port's
    ``make_grad_fn`` at ``params`` (numpy tree)."""
    tcfg = tcfg or cfgs()[1]
    metrics, grads = make_grad_fn(tcfg, TCLS, TrainConfig(**tc_kw))(params_from_numpy(params), batch, generator)
    return {k: float(v) for k, v in metrics.items()}, to_np(grads)


def jax_steps(tc_kw: dict, params: dict, batches, keys=None, jcfg=None, steps_per_epoch: int = 1):
    """Train steps of the JAX package from ``params``: (metrics per step,
    flat params after each step, the final state)."""
    jcfg = jcfg or cfgs()[0]
    tc = JTrainConfig(**tc_kw)
    p = jax.tree.map(jnp.asarray, params)
    opt = j_make_optimizer(tc, p, steps_per_epoch)
    step, _ = j_make_train_step(jcfg, JCLS, tc, opt)
    state = JTrainState(params=jax.tree.map(jnp.copy, p), opt_state=opt.init(p), step=jnp.zeros((), jnp.int32),
                        ema_params=jax.tree.map(jnp.copy, p) if tc.ema_decay > 0 else None)
    metrics, after = [], []
    for i, b in enumerate(batches):
        key = jax.random.PRNGKey(i if keys is None else keys[i])
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, key)
        metrics.append({k: float(v) for k, v in m.items()})
        after.append(to_np(state.params))
    return metrics, after, state


def port_steps(tc_kw: dict, params: dict, batches, tcfg=None, steps_per_epoch: int = 1, seed: int = 0):
    """The same through the port's ``make_train_step`` (one generator)."""
    tcfg = tcfg or cfgs()[1]
    tc = TrainConfig(**tc_kw)
    p = params_from_numpy(params)
    opt = make_optimizer(tc, p, steps_per_epoch)
    step, _ = make_train_step(tcfg, TCLS, tc, opt)
    state = TrainState(params=p, opt_state=opt.init(p), step=0,
                       ema_params=params_from_numpy(params) if tc.ema_decay > 0 else None)
    gen = torch.Generator().manual_seed(seed)
    metrics, after = [], []
    for b in batches:
        state, m = step(state, b, gen)
        metrics.append({k: float(v) for k, v in m.items()})
        after.append(to_np(state.params))
    return metrics, after, state


def without_key_bias(key: str, x: np.ndarray) -> np.ndarray:
    """The attention's key bias gets a gradient of exactly zero in exact
    arithmetic (the softmax ignores a shift shared by a query's keys): each
    package's value is its own rounding noise, so the query and value
    thirds of ``qkv/bias`` are compared."""
    if not key.endswith("attn/qkv/bias"):
        return x
    w = x.shape[0] // 3
    return np.concatenate([x[:w], x[2 * w:]])


def assert_close_rel(got: dict, ref: dict, tol: float = TOL, what: str = "", keys=None) -> int:
    """Each leaf of ``got`` within ``tol`` of ``ref`` in relative L2 (the key
    bias's key third left out); a leaf zero in ``ref`` must be zero in
    ``got``. Returns the leaves compared that were non-zero."""
    nonzero = 0
    for k in keys if keys is not None else got:
        g, r = without_key_bias(k, got[k]), without_key_bias(k, ref[k])
        if not r.any():
            assert not g.any(), (what, k, np.abs(g).max())
            continue
        nonzero += 1
        err = np.linalg.norm(g - r)
        assert err <= tol * np.linalg.norm(r), (what, k, err, np.linalg.norm(r))
    return nonzero


def from_flat(template: dict, flat: dict) -> dict:
    """The nested numpy tree of ``template``'s structure holding ``flat``'s
    values (path keys as ``flat_leaves`` writes them)."""
    return map_with_paths(template, lambda path, _: flat["/".join(path)])


def updates(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
