"""The port's process group (``evr_tpu_torch.parallel.multihost``) and
launcher (``evr_tpu_torch.tools.pod_launch``) held to
``tests/test_multihost.py`` and ``tests/test_pod_cli_e2e.py``: two real OS
processes of two CPU slots each, joined by Gloo, compute the global-batch
InfoNCE, a data-parallel step, an FSDP step whose shards span both processes
and a ``Trainer.fit``, each equal to the JAX package's one-device step on the
global batch (losses at 1e-5, params rtol 1e-4 / atol 1e-6);
the coordinator alone writes the checkpoint; the pod CLI fine-tunes under
``--fsdp`` with an autosave and resumes from it."""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from evr_tpu.parallel.contrastive import infonce_loss_single as jinfonce
from evr_tpu.parallel.multihost import process_slice as jprocess_slice
from evr_tpu.training import TrainConfig as JTrainConfig
from evr_tpu.training import make_optimizer as j_make_optimizer
from evr_tpu.training import make_train_step as j_make_train_step
from evr_tpu.training.data import CaptionDataset as JCaptionDataset
from evr_tpu.training.finetune import TrainState as JTrainState
from evr_tpu_torch.models.clip import init_clip_params
from evr_tpu_torch.parallel import multihost as mh
from evr_tpu_torch.parallel.fsdp import gather_tree
from evr_tpu_torch.training import CaptionDataset
from evr_tpu_torch.training.sharded_ckpt import restore_sharded
from evr_tpu_torch.training.finetune import flat_leaves

import torch_multihost_worker as worker
from torch_threads import one_torch_thread  # noqa: F401
from torch_trainer_twins import cfgs, to_np

REPO = pathlib.Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def jax_train_step_single(global_b: int) -> tuple[float, dict]:
    """The expectation, as ``tests/multihost_worker.py::run_train_step_single``
    computes it: one JAX one-device step on the whole global batch, from the
    workers' params → (contrastive loss, flat params after)."""
    tc = JTrainConfig(compute_dtype="float32", patch_drop=0.0, batch_size=global_b)
    params = {"clip": jax.tree.map(jnp.asarray, init_clip_params(0, worker.tiny_cfg()))}
    opt = j_make_optimizer(tc, params)
    step, _ = j_make_train_step(cfgs()[0], None, tc, opt)
    state = JTrainState(params=params, opt_state=opt.init(params), step=jnp.zeros((), jnp.int32))
    batch = {k: jnp.asarray(v) for k, v in worker.full_global_batch(global_b).items()}
    state, metrics = step(state, batch, jax.random.PRNGKey(0))
    return float(metrics["contrastive_loss"]), to_np(state.params)


def test_process_slice_disjoint_covering():
    for n in (1, 2, 3):
        for p in range(n):
            assert mh.process_slice(12, process_id=p, process_count=n) == jprocess_slice(12, p, n)
    seen = []
    for p in range(3):
        s = mh.process_slice(12, process_id=p, process_count=3)
        seen.extend(range(s.start, s.stop))
    assert seen == list(range(12))
    with pytest.raises(ValueError):
        mh.process_slice(10, process_id=0, process_count=3)


def test_bootstrap_single_process_noop():
    assert "EVR_TPU_COORDINATOR" not in os.environ
    assert mh.bootstrap() == (0, 1)
    assert mh.is_coordinator() and mh.process_count() == 1
    t = torch.arange(4.0)
    assert mh.all_gather(t)[0] is t and mh.gather_rows(t) is t
    assert mh.broadcast_from_coordinator({"a": [t]})["a"][0] is t
    mh.barrier()


def test_two_process_training_step_exact(tmp_path):
    """``tests/test_multihost.py::test_two_process_training_step_exact`` in
    one spawn of two processes."""
    nproc, port = 2, _free_port()
    procs = []
    for pid in range(nproc):
        env = dict(os.environ, EVR_TPU_COORDINATOR=f"localhost:{port}", EVR_TPU_NUM_PROCESSES=str(nproc),
                   EVR_TPU_PROCESS_ID=str(pid), EVR_TPU_CPU_DEVICES="2",
                   EVR_TPU_TEST_CKPT_DIR=str(tmp_path), OMP_NUM_THREADS="1",
                   PYTHONPATH=f"{REPO}:{os.environ.get('PYTHONPATH', '')}")
        procs.append(subprocess.Popen([sys.executable, str(pathlib.Path(worker.__file__))], env=env,
                                      cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    results, logs = {}, {}
    for pid, p in enumerate(procs):
        out, _ = p.communicate(timeout=300)
        logs[pid] = out
        for line in out.splitlines():
            if line.startswith("MHRESULT "):
                results[pid] = json.loads(line[len("MHRESULT "):])
    assert all(p.returncode == 0 for p in procs), logs
    assert set(results) == {0, 1}, logs
    r0, r1 = results[0], results[1]
    assert r0["slots"] == r1["slots"] == 4 and r0["bc_ok"] and r1["bc_ok"]
    global_b = 8
    # every process computes the same global scalars and the same update
    for key in ("infonce", "train_loss", "fsdp_loss", "fit_loss"):
        assert r0[key] == r1[key], key
    np.testing.assert_array_equal(r0["proj_after"], r1["proj_after"])
    img, txt = worker.contrastive_features(global_b)
    expected = float(jinfonce(jnp.asarray(img), jnp.asarray(txt), jnp.asarray(np.log(1 / 0.07))))
    np.testing.assert_allclose(r0["infonce"], expected, rtol=1e-5)
    loss, after = jax_train_step_single(global_b)
    for key in ("train_loss", "fsdp_loss", "fit_loss"):
        np.testing.assert_allclose(r0[key], loss, rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(r0["proj_after"], after["clip/visual/proj"], rtol=1e-4, atol=1e-6)
    # the FSDP params the two processes wrote shard by shard, read back on one slot
    restored = gather_tree(restore_sharded(tmp_path / "fsdp_params", {"clip": {
        k: v for k, v in worker.init_params()["clip"].items()}}))
    for k, v in flat_leaves(restored).items():
        np.testing.assert_allclose(v.numpy(), after[k], rtol=1e-4, atol=1e-6, err_msg=k)
    assert r0["ckpt_written"] and r1["ckpt_written"]
    assert (tmp_path / "mh_ckpt" / "final_checkpoint.pt").exists()


def test_dataset_process_sharding(tmp_path):
    """``tests/test_multihost.py::test_dataset_process_sharding``: the same
    disjoint equal-length strides as the JAX package's loader."""
    from PIL import Image

    items = []
    for i in range(10):
        p = tmp_path / f"{i}.jpg"
        Image.fromarray(np.full((48, 48, 3), i * 20, np.uint8)).save(p)
        items.append((p, f"caption {i}", i))
    datasets = []
    for cls in (CaptionDataset, JCaptionDataset):
        ds = object.__new__(cls)
        ds.base_dir, ds.category_mapping, ds.items = tmp_path, {}, items
        datasets.append(ds)

    def labels(ds, index, count, batch_size):
        return [int(x) for b in ds.batches(batch_size=batch_size, image_size=32, seed=7, epoch=3,
                                           process_index=index, process_count=count) for x in b["labels"]]

    port, ref = datasets
    l0, l1 = labels(port, 0, 2, 2), labels(port, 1, 2, 2)
    assert len(l0) == len(l1) == 4 and set(l0).isdisjoint(l1)
    assert l0 == labels(ref, 0, 2, 2) and l1 == labels(ref, 1, 2, 2)
    full = labels(port, 0, 1, 4)
    assert len(full) == 8 and full == labels(ref, 0, 1, 4)
    with pytest.raises(ValueError):
        next(iter(port.batches(batch_size=2, process_index=2, process_count=2)))


def test_pod_launch_finetune_fsdp_autosave_resume(tmp_path):
    """``tests/test_pod_cli_e2e.py`` and ``test_multihost.py::test_pod_launch_tool``:
    ``pod_launch -n 2 --cpu-devices 2 -- finetune --fsdp --save-every-steps 1``
    trains over four slots in two processes, then resumes from the
    autosave; a failing worker fails the launch with its code."""
    from PIL import Image

    from evr_tpu_torch.tools.pod_launch import launch

    rng = np.random.default_rng(0)
    (tmp_path / "imgs").mkdir()
    caps = {}
    for i in range(16):
        name = f"f{i:02d}.jpg"
        Image.fromarray((rng.random((64, 64, 3)) * 255).astype(np.uint8)).save(tmp_path / "imgs" / name)
        caps[name] = {"caption": f"synthetic frame number {i}", "category": ["Violence", "NonViolence"][i % 2]}
    (tmp_path / "caps.json").write_text(json.dumps(caps))
    save_dir = tmp_path / "ckpt"
    env = dict(os.environ, PYTHONPATH=f"{REPO}:{os.environ.get('PYTHONPATH', '')}")

    def run(extra):
        cmd = [sys.executable, "-m", "evr_tpu_torch.tools.pod_launch", "-n", "2", "--cpu-devices", "2", "--",
               sys.executable, "-m", "evr_tpu_torch.tools.finetune", "--device", "cpu",
               "--train-json", str(tmp_path / "caps.json"), "--data-dir", str(tmp_path / "imgs"),
               "--model", "ViT-Tiny-Test", "--batch-size", "8", "--epochs", "1", "--freeze-layers", "0",
               "--save-dir", str(save_dir), "--fsdp", *extra]
        return subprocess.run(cmd, env=env, cwd=str(REPO), capture_output=True, text=True, timeout=300)

    out = run(["--save-every-steps", "1"])
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-2000:]
    assert "[proc 1] mesh {'data': 4} over 2 process(es), fsdp" in out.stdout
    assert (save_dir / "final_checkpoint.pt").exists() and (save_dir / "autosave.pt").exists()
    out2 = run(["--resume-from", "autosave"])
    assert out2.returncode == 0, out2.stdout[-4000:] + out2.stderr[-2000:]
    assert "resumed from autosave mid-epoch" in out2.stdout
    assert launch([sys.executable, "-c", "import sys; sys.exit(3)"], num_processes=2, cpu_devices=1) == 3
