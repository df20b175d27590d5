"""Worker of the port's two-process test (``tests/test_torch_multihost.py``).

Run as ``python tests/torch_multihost_worker.py`` in N processes, each given
``EVR_TPU_COORDINATOR`` / ``EVR_TPU_NUM_PROCESSES`` / ``EVR_TPU_PROCESS_ID``
and ``EVR_TPU_CPU_DEVICES=2``: ``parallel.multihost.bootstrap(device="cpu")``
joins them in a Gloo group and the global mesh holds 2N CPU slots. Mirrors
``tests/multihost_worker.py``. Imported (not run) by the test for the shared
configuration and batch functions; it imports nothing of JAX.
"""

import json
import os
import sys

import numpy as np
import torch


def tiny_cfg():
    from evr_tpu_torch.models.clip import CLIPConfig, TextConfig, VisionConfig

    return CLIPConfig(
        embed_dim=32,
        vision=VisionConfig(image_size=32, patch_size=8, width=64, layers=2, heads=4),
        text=TextConfig(context_length=16, vocab_size=600, width=64, layers=2, heads=4),
    )


def full_global_batch(global_b: int) -> dict:
    """The same global batch in every process; each takes its slice."""
    rng = np.random.default_rng(7)
    tokens = np.zeros((global_b, 16), np.int64)
    for i in range(global_b):
        ln = int(rng.integers(3, 10))
        tokens[i, :ln] = rng.integers(1, 500, size=ln)
        tokens[i, ln] = 599
    return {
        "images": (rng.random((global_b, 32, 32, 3)) * 255).astype(np.uint8),
        "tokens": tokens,
        "labels": rng.integers(0, 3, size=global_b).astype(np.int64),
    }


def contrastive_features(global_b: int, dim: int = 32):
    rng = np.random.default_rng(11)
    img = rng.normal(size=(global_b, dim)).astype(np.float32)
    txt = rng.normal(size=(global_b, dim)).astype(np.float32)
    return (img / np.linalg.norm(img, axis=-1, keepdims=True),
            txt / np.linalg.norm(txt, axis=-1, keepdims=True))


def train_config(global_b: int, **kw):
    from evr_tpu_torch.training import TrainConfig

    return TrainConfig(compute_dtype="float32", patch_drop=0.0, batch_size=global_b, **kw)


def init_params() -> dict:
    from evr_tpu_torch.models.clip import init_clip_params
    from evr_tpu_torch.models.convert import params_from_numpy

    return {"clip": params_from_numpy(init_clip_params(0, tiny_cfg()))}


def main() -> None:
    from evr_tpu_torch.parallel import multihost as mh
    from evr_tpu_torch.parallel.contrastive import make_sharded_infonce
    from evr_tpu_torch.parallel.fsdp import fsdp_state_shardings, shard_tree
    from evr_tpu_torch.training import Trainer, TrainState, make_optimizer, make_train_step
    from evr_tpu_torch.training.sharded_ckpt import save_sharded

    torch.set_num_threads(1)
    pid, nproc = mh.bootstrap(device="cpu")
    assert nproc == int(os.environ["EVR_TPU_NUM_PROCESSES"]) and mh.backend() == "gloo"
    mesh = mh.global_mesh(device="cpu")
    assert len(mesh.local_slots) == 2 and mesh.size == 2 * nproc
    global_b = 2 * mesh.size
    sl = mh.process_slice(global_b)

    # 1) the global-batch InfoNCE across the process boundary
    img, txt = contrastive_features(global_b)
    batch_f = mh.make_global_batch(mesh, {"img": img[sl], "txt": txt[sl]})
    infonce = float(make_sharded_infonce(mesh)(batch_f["img"], batch_f["txt"],
                                               torch.tensor(np.log(1 / 0.07), dtype=torch.float32)))

    # 2) broadcast: the other processes start from garbage, end with process 0's
    params = init_params()
    reference = params["clip"]["visual"]["proj"].clone()
    if pid != 0:
        params = {"clip": {k: v for k, v in params["clip"].items()}}
        params["clip"]["visual"] = {**params["clip"]["visual"],
                                    "proj": torch.full_like(reference, 999.0)}
    params = mh.broadcast_from_coordinator(params)
    bc_ok = bool(torch.equal(params["clip"]["visual"]["proj"], reference))

    # 3) one data-parallel step over the two processes' slots
    tc = train_config(global_b)
    batch = full_global_batch(global_b)
    local = mh.make_global_batch(mesh, {k: v[sl] for k, v in batch.items()})
    opt = make_optimizer(tc, params)
    step, _ = make_train_step(tiny_cfg(), None, tc, opt, mesh=mesh)
    state, metrics = step(TrainState(params, opt.init(params), 0), local)
    train_loss = float(metrics["contrastive_loss"])
    proj = state.params["clip"]["visual"]["proj"].detach().numpy()

    # 3b) the same step under FSDP, the shards spanning both processes, then
    # its params written shard by shard from both
    p_f = init_params()
    opt_f = make_optimizer(tc, p_f)
    sh = fsdp_state_shardings(p_f, opt_f, mesh, min_size=256)
    state_f = TrainState(shard_tree(p_f, sh.params), shard_tree(opt_f.init(p_f), sh.opt_state), 0)
    step_f, _ = make_train_step(tiny_cfg(), None, tc, opt_f, mesh=mesh, state_shardings=sh)
    state_f, m_f = step_f(state_f, local)
    fsdp_loss = float(m_f["contrastive_loss"])
    ckpt_dir = os.environ["EVR_TPU_TEST_CKPT_DIR"]
    save_sharded(os.path.join(ckpt_dir, "fsdp_params"), state_f.params)

    # 4) Trainer.fit over the processes: each feeds its rows; only the
    # coordinator writes the checkpoint
    tc2 = train_config(global_b, epochs=1, freeze_layers=0, lr=1e-4,
                       save_dir=os.path.join(ckpt_dir, "mh_ckpt"))
    trainer = Trainer(tiny_cfg(), init_params()["clip"], tc2, mesh=mesh, log_fn=lambda s: None)
    assert trainer._multihost
    fit = trainer.fit(lambda e: iter([{k: v[sl] for k, v in batch.items()}]))
    fit_loss = fit["history"][-1]["train_contrastive_loss"]
    mh.barrier("multihost-test-end")
    ckpt_written = os.path.exists(os.path.join(ckpt_dir, "mh_ckpt", "final_checkpoint.pt"))
    print("MHRESULT " + json.dumps({
        "pid": pid, "nproc": nproc, "slots": mesh.size, "infonce": infonce, "bc_ok": bc_ok,
        "train_loss": train_loss, "fsdp_loss": fsdp_loss, "fit_loss": fit_loss,
        "ckpt_written": ckpt_written, "proj_after": proj.tolist(),
    }), flush=True)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    main()
