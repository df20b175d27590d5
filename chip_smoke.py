#!/usr/bin/env python3
"""Drive the evr_tpu_torch port on one NVIDIA GPU and check it end to end.

Run from the repository root: ``python3 chip_smoke.py``. It needs one CUDA
card and the CUDA toolkit; it imports neither JAX nor the ``evr_tpu``
package. Phases, each fatal on failure:

1. the card: name and power limit (``nvidia-smi``); TF32 off for matmuls and
   cuDNN, so fp32 comparisons are full fp32;
2. build: every kernel of the main path compiled from ``ops/csrc``;
3. kernel parity: K1 (``fused_attn_block``) and K2 (``fused_mlp_block``)
   against their plain PyTorch versions at the ViT-B/32 main-path shapes,
   vision (B=256, T=50, W=768, H=12) and text (B=16, T=77, W=512, H=8,
   causal), in bfloat16 and float32;
4. main path: ``EmbeddingEngine("ViT-B/32", device="cuda")`` with seeded
   random weights embeds 1,024 synthetic frames of four videos at batch 256,
   the data root is written, ``ServingContext`` boots from it and
   ``create_app`` answers /api/search requests; the launch counts of K1 and
   K2 over that run, and the kernel path's embeddings and top-10 rankings
   against the plain versions' on the same frames and queries;
5. times: each kernel, its plain version and a PyTorch library composition of
   the same half, by CUDA events at the vision shape; encode frames/s and
   the p50 of a text query.

The line before the last is one JSON object with a record per kernel; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import tempfile
import time

H100_BF16_FLOPS = 989e12  # dense tensor-core peak, H100 SXM data sheet
H100_BYTES_PER_S = 3.35e12

VISION = dict(B=256, T=50, W=768, H=12, causal=False)
TEXT = dict(B=16, T=77, W=512, H=8, causal=True)
FP32_TOL = 2e-4  # max abs, fp32 kernel vs plain version (accumulation order only)
BF16_TOL = 3e-2  # max abs on unit-variance activations: about 2 bf16 ulps below 4
BF16_MIN_COS = 0.9999  # per output row, bf16
EMBED_MIN_COS = 0.999  # kernel-path vs plain-path frame embeddings, per row
# A frame may cross the top-10 cut between the kernel path and the plain
# path only where the plain path scores it this close to its own 10th score.
# Under one query vector the two frame paths' scores differed by at most
# 1.3e-3 on an H100 with this script (text queries; 2.7e-4 for frame
# queries): ONE_VECTOR_RANK_NOISE is about twice that. With each path's own
# text vectors, as /api/search ranks, they differed by up to 1.9e-3:
# SERVED_RANK_NOISE is about twice that.
ONE_VECTOR_RANK_NOISE = 2.5e-3
SERVED_RANK_NOISE = 4e-3
MODEL = "ViT-B/32"
N_FRAMES, N_VIDEOS, BATCH = 1024, 4, 256
N_FRAME_QUERIES = 8
QUERIES = (
    "a red car on a street", "people walking in a park", "a dog running",
    "a crowd at a concert", "a boat on the water", "text on a sign",
)


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# -- 1. the card -------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0]


# -- shared helpers ----------------------------------------------------------


def block_params(torch, W: int, gen, device):
    """One residual block's fp32 parameters at CLIP's init scales."""
    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    proj_std = W ** -0.5 * (2 * 12) ** -0.5
    return {
        "ln_1": {"scale": 1.0 + normal((W,), 0.1), "bias": normal((W,), 0.1)},
        "attn": {
            "qkv": {"kernel": normal((W, 3 * W), W ** -0.5), "bias": normal((3 * W,), 0.02)},
            "out": {"kernel": normal((W, W), proj_std), "bias": normal((W,), 0.02)},
        },
        "ln_2": {"scale": 1.0 + normal((W,), 0.1), "bias": normal((W,), 0.1)},
        "mlp": {
            "fc": {"kernel": normal((W, 4 * W), (2 * W) ** -0.5), "bias": normal((4 * W,), 0.02)},
            "proj": {"kernel": normal((4 * W, W), proj_std), "bias": normal((W,), 0.02)},
        },
    }


def unit_activations(torch, shape, gen, device):
    """Unit-variance activations, uniform on [-sqrt 3, sqrt 3]."""
    return (torch.rand(shape, generator=gen, device=device) * 2 - 1) * math.sqrt(3.0)


def compare(torch, got, ref):
    g, r = got.float().reshape(-1, got.shape[-1]), ref.float().reshape(-1, ref.shape[-1])
    err = (g - r).abs().max().item()
    cos = torch.nn.functional.cosine_similarity(g, r, dim=-1).min().item()
    finite = bool(torch.isfinite(g).all().item())
    return err, cos, finite


def cuda_ms(torch, fn, iters: int = 30, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


# -- 2. build ----------------------------------------------------------------


def phase_build():
    from evr_tpu_torch.ops import build

    t0 = time.perf_counter()
    times = build.build()
    total = time.perf_counter() - t0
    for name in build.KERNEL_SOURCES:
        path = build.library_path(name)
        check(path.exists(), f"{name}: no library after the build")
        report = path.with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "spill" in line or "registers" in line:
                    log(f"  ptxas {name}: {line.strip()}")
    log(f"build: {json.dumps({k: round(v, 1) for k, v in times.items()})} "
        f"total {total:.1f} s (0 = already built)")


# -- 3. kernel parity --------------------------------------------------------


def phase_parity(torch):
    from evr_tpu_torch.ops import block_fused as bf

    dev = torch.device("cuda")
    worst = {"fused_attn_block": 0.0, "fused_mlp_block": 0.0}
    for shape_name, s in (("vision", VISION), ("text", TEXT)):
        gen = torch.Generator(device=dev).manual_seed(1)
        attn_args, mlp_args = bf.block_half_params(block_params(torch, s["W"], gen, dev))
        x32 = unit_activations(torch, (s["B"], s["T"], s["W"]), gen, dev)
        for dt in (torch.bfloat16, torch.float32):
            x = x32.to(dt)
            cast = lambda args: [a.to(dt) for a in args]  # noqa: E731
            for name, kern, plain, kw, args in (
                ("fused_attn_block", bf.fused_attn_block, bf.fused_attn_block_plain,
                 dict(n_heads=s["H"], causal=s["causal"]), attn_args),
                ("fused_mlp_block", bf.fused_mlp_block, bf.fused_mlp_block_plain,
                 dict(activation="quick_gelu"), mlp_args),
            ):
                got = kern(x, *args, **kw)
                torch.cuda.synchronize()
                ref = plain(x, *cast(args), **kw)
                err, cos, finite = compare(torch, got, ref)
                tag = f"{name} {shape_name} {str(dt).split('.')[-1]}"
                log(f"parity {tag}: max_abs_err={err:.3e} min_row_cos={cos:.7f}")
                check(finite, f"{tag}: non-finite output")
                if dt == torch.float32:
                    check(err <= FP32_TOL, f"{tag}: max abs err {err} > {FP32_TOL}")
                else:
                    check(err <= BF16_TOL, f"{tag}: max abs err {err} > {BF16_TOL}")
                    check(cos >= BF16_MIN_COS, f"{tag}: row cosine {cos} < {BF16_MIN_COS}")
                    if shape_name == "vision":
                        worst[name] = max(worst[name], err)
        # GELU variant of K2 (OpenCLIP towers), checked at the vision width
        if shape_name == "vision":
            for dt in (torch.bfloat16, torch.float32):
                x = x32.to(dt)
                got = bf.fused_mlp_block(x, *mlp_args, activation="gelu")
                ref = bf.fused_mlp_block_plain(x, *[a.to(dt) for a in mlp_args], activation="gelu")
                err, cos, finite = compare(torch, got, ref)
                tag = f"fused_mlp_block gelu vision {str(dt).split('.')[-1]}"
                log(f"parity {tag}: max_abs_err={err:.3e} min_row_cos={cos:.7f}")
                check(finite, f"{tag}: non-finite output")
                tol = FP32_TOL if dt == torch.float32 else BF16_TOL
                check(err <= tol, f"{tag}: max abs err {err} > {tol}")
    return worst


# -- 4. main path ------------------------------------------------------------


def synthetic_frames(torch, n: int, size: int, patch: int):
    """Frames as uint8 [n, size, size, 3], each its own scene: a random
    colour per patch, a horizontal gradient and seeded pixel noise."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    g = size // patch
    layout = torch.randint(0, 256, (n, g, g, 3), generator=gen, device="cuda").float()
    layout = layout.repeat_interleave(patch, 1).repeat_interleave(patch, 2)
    ramp = torch.linspace(-30, 30, size, device="cuda")
    noise = torch.randn((n, size, size, 3), generator=gen, device="cuda") * 1.5
    frames = layout + ramp[None, :, None, None] + noise
    return frames.clamp(0, 255).to(torch.uint8).cpu().numpy()


def rank_check(got, ref, got_q, ref_q, noise: float, k: int = 10):
    """Hold the kernel path's top-k to the plain path's, query by query.

    ``got``/``ref`` are the two paths' unit frame embeddings, ``got_q``/
    ``ref_q`` their query vectors. A frame in one top-k and not the other is
    a violation unless the plain path scores it within ``noise`` of its own
    k-th score. Returns (violations, overlaps, frames within the noise
    band of the cut, largest score difference between the paths)."""
    import numpy as np

    violations, overlaps, band, diff = 0, [], [], 0.0
    for gq, rq in zip(got_q, ref_q):
        s_got, s_ref = got @ gq, ref @ rq
        top_got = set(np.argsort(-s_got, kind="stable")[:k].tolist())
        top_ref_order = np.argsort(-s_ref, kind="stable")[:k]
        top_ref = set(top_ref_order.tolist())
        cut = s_ref[top_ref_order[-1]]
        violations += int(sum(abs(s_ref[j] - cut) > noise for j in top_got ^ top_ref))
        overlaps.append(len(top_got & top_ref))
        band.append(int((np.abs(s_ref - cut) <= noise).sum()))
        diff = max(diff, float(np.abs(s_got - s_ref).max()))
    return violations, overlaps, band, diff


def write_video(path: pathlib.Path, n_frames: int) -> None:
    """A small real video file: boot keeps only videos whose file exists."""
    import cv2
    import numpy as np

    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (64, 64))
    for i in range(n_frames):
        writer.write(np.full((64, 64, 3), i % 256, np.uint8))
    writer.release()


def write_data_root(root: pathlib.Path, names, embeddings_per_video):
    import numpy as np

    from evr_tpu_torch.config import DataRootConfig
    from evr_tpu_torch.index import VideoRegistry

    cfg = DataRootConfig(root).ensure()
    registry = VideoRegistry(cfg.mapping_path)
    for name, emb in zip(names, embeddings_per_video):
        np.save(cfg.embedding_dir / f"{name}_embeddings.npy", emb)
        frames_dir = cfg.frames_dir / name
        frames_dir.mkdir(parents=True, exist_ok=True)
        video = cfg.video_dir / f"{name}.mp4"
        write_video(video, len(emb))
        records = [
            {
                "id": f"{name}-{i}", "media_type": "image",
                "filepath": str(frames_dir / f"{i}.jpg"), "tags": [],
                "metadata": {}, "video": f"videos/{name}.mp4",
                "frameid": f"{i}.jpg", "frameidx": i,
                "text_detections": {"detections": []},
                "object_detections": {"detections": []},
            }
            for i in range(len(emb))
        ]
        meta = cfg.metadata_dir / f"{name}_metadata.json"
        meta.write_text(json.dumps(records))
        registry.add(
            name, metadata_file=meta, embeddings_file=cfg.embedding_dir / f"{name}_embeddings.npy",
            video_path=video, frames_dir=frames_dir, embedding_model="original",
        )
    return cfg


def phase_main_path(torch):
    import dataclasses

    import numpy as np
    from werkzeug.test import Client

    from evr_tpu_torch.index import EmbeddingEngine
    from evr_tpu_torch.models.clip import encode_staged_u8, encode_text
    from evr_tpu_torch.ops import block_fused as bf
    from evr_tpu_torch.serving import ServingContext, create_app

    t0 = time.perf_counter()
    engine = EmbeddingEngine(MODEL, device="cuda", batch_size=BATCH, rng_seed=0)
    log(f"engine: {MODEL} random weights (seed 0), {engine.compute_dtype}, "
        f"set up in {time.perf_counter() - t0:.1f} s")
    size = engine.cfg.vision.image_size
    frames = synthetic_frames(torch, N_FRAMES, size, engine.cfg.vision.patch_size)
    engine.encode_staged_images(frames[:BATCH])  # first call: kernel libraries load
    torch.cuda.synchronize()

    bf.fused_attn_block.launches = 0
    bf.fused_mlp_block.launches = 0
    t0 = time.perf_counter()
    emb = engine.encode_staged_images(frames)
    torch.cuda.synchronize()
    encode_s = time.perf_counter() - t0
    check(emb.shape == (N_FRAMES, engine.cfg.embed_dim), f"embedding shape {emb.shape}")
    check(bool(np.isfinite(emb).all()), "non-finite frame embeddings")
    n_batches = -(-N_FRAMES // BATCH)

    names = [f"video{v}" for v in range(N_VIDEOS)]
    per = N_FRAMES // N_VIDEOS
    request_ms = []
    with tempfile.TemporaryDirectory() as tmp:
        cfg = write_data_root(pathlib.Path(tmp), names, [emb[v * per:(v + 1) * per] for v in range(N_VIDEOS)])
        ctx = ServingContext(cfg, engine=engine)
        loaded = ctx.boot()
        check(loaded == names, f"boot loaded {loaded}")
        client = Client(create_app(ctx))
        check(client.get("/health").status_code == 200, "/health")
        check(client.get("/api/videos").status_code == 200, "/api/videos")
        for i, q in enumerate(QUERIES):
            body = {"query": q, "search_type": "text", "top_k": 10, "adaptive_threshold": -1.0,
                    "search_method": "text_clip" if i % 2 == 0 else "text_adaptive"}
            if i == len(QUERIES) - 1:
                body["videoId"] = "video-2"
            t1 = time.perf_counter()
            resp = client.post("/api/search", json=body)
            request_ms.append((time.perf_counter() - t1) * 1e3)
            check(resp.status_code == 200, f"/api/search {q!r}: HTTP {resp.status_code}")
            events = json.loads(resp.get_data(as_text=True))["events"]
            check(len(events) > 0, f"/api/search {q!r}: no events")
            check(all(math.isfinite(e["clip_similarity"]) for e in events), "non-finite score")
            log(f"search {body['search_method']:13s} {q!r}: HTTP 200, {len(events)} events, "
                f"top {events[0]['videoId']}/{events[0]['id']} "
                f"score {events[0]['clip_similarity']:.4f}, {request_ms[-1]:.1f} ms")
    launches = {"fused_attn_block": bf.fused_attn_block.launches,
                "fused_mlp_block": bf.fused_mlp_block.launches}
    n_text = len(QUERIES)
    n_blocks = engine.cfg.vision.layers - 1  # the last block is the pooled-row one
    expected = n_blocks * n_batches + (engine.cfg.text.layers - 1) * n_text
    log(f"launches over the main path: {launches} (expected {expected} each: "
        f"11 per encode batch per tower, {n_batches} frame batches, {n_text} text encodes)")
    for name, n in launches.items():
        check(n == expected > 0, f"{name}: {n} launches, expected {expected}")

    # kernel path against the plain versions on the card, same frames
    plain_cfg = dataclasses.replace(engine.cfg, attn_impl="plain")
    with torch.inference_mode():
        ref = []
        for i in range(0, N_FRAMES, BATCH):
            staged = torch.from_numpy(frames[i:i + BATCH]).cuda()
            ref.append(encode_staged_u8(engine.params, plain_cfg, staged, dtype=engine.compute_dtype))
        ref = torch.cat(ref).float().cpu().numpy()
    got_n = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    ref_n = ref / np.linalg.norm(ref, axis=1, keepdims=True)
    cos = (got_n * ref_n).sum(1)
    log(f"frame embeddings, kernel path vs plain path: min row cos {cos.min():.6f}")
    check(cos.min() >= EMBED_MIN_COS, f"embedding cosine {cos.min()} < {EMBED_MIN_COS}")
    # the text tower: kernel path against plain path, same queries
    tokens = torch.from_numpy(engine.tokenizer(list(QUERIES))).cuda()
    with torch.inference_mode():
        txt_ref = encode_text(engine.params, plain_cfg, tokens, dtype=engine.compute_dtype,
                              eot_fast_final=True).float().cpu().numpy()
    txt_ref /= np.linalg.norm(txt_ref, axis=1, keepdims=True)
    txt = engine.encode_texts(list(QUERIES))
    tcos = (txt * txt_ref).sum(1)
    log(f"text embeddings, kernel path vs plain path: min row cos {tcos.min():.6f}")
    check(tcos.min() >= EMBED_MIN_COS, f"text embedding cosine {tcos.min()} < {EMBED_MIN_COS}")

    # rankings: the frame paths under the plain path's text vectors and
    # under its vectors of a few frames; then the served ranking, each text
    # query through each path's own towers
    picks = np.linspace(0, N_FRAMES - 1, N_FRAME_QUERIES).astype(int)
    cases = (
        ("text queries, one query vector", txt_ref, txt_ref, ONE_VECTOR_RANK_NOISE),
        ("frame queries, one query vector", ref_n[picks], ref_n[picks], ONE_VECTOR_RANK_NOISE),
        ("text queries, each path's own", txt, txt_ref, SERVED_RANK_NOISE),
    )
    for kind, got_q, ref_q, noise in cases:
        bad, overlaps, band, diff = rank_check(got_n, ref_n, got_q, ref_q, noise)
        log(f"top-10 rankings, {kind}, kernel vs plain path: overlap {overlaps}, "
            f"frames within {noise} of the 10th score {band}, largest score "
            f"difference {diff:.2e}, violations {bad}")
        check(bad == 0, f"{kind}: {bad} top-10 swaps wider than {noise}")
    # the check must reject frame embeddings off by the row-cosine tolerance
    # (0.999): seeded noise of that size on the kernel path's frames
    noise = np.random.default_rng(0).standard_normal(got_n.shape).astype(np.float32)
    off = got_n + noise * math.sqrt((1 / EMBED_MIN_COS**2 - 1) / got_n.shape[1])
    off /= np.linalg.norm(off, axis=1, keepdims=True)
    bad_off = sum(rank_check(off, ref_n, q, q, ONE_VECTOR_RANK_NOISE)[0] for q in (txt_ref, ref_n[picks]))
    log(f"the one-vector ranking checks on frame embeddings off by row cosine "
        f"{float((off * got_n).sum(1).mean()):.5f}: {bad_off} violations")
    check(bad_off > 0, "the ranking check passes embeddings off by row cosine 0.999")

    # text-query latency: encode + search of a fresh query, no result cache
    lat = []
    for i in range(20):
        t1 = time.perf_counter()
        vec = engine.encode_texts([f"query number {i} about a scene"])
        ctx.index.search(vec, 10)
        lat.append((time.perf_counter() - t1) * 1e3)
    return {
        "launches": launches,
        "encode_frames_per_s": N_FRAMES / encode_s,
        "text_query_p50_ms": statistics.median(lat),
        "request_p50_ms": statistics.median(request_ms),
    }


# -- 5. times ----------------------------------------------------------------


def half_costs(name: str, s: dict, elt: int):
    """(operations, bytes) one call must do: each input read once, each
    output written once."""
    rows, W = s["B"] * s["T"], s["W"]
    if name == "fused_attn_block":
        flops = 2 * rows * W * 3 * W + 4 * s["B"] * s["T"] * s["T"] * W + 2 * rows * W * W
        weights = 4 * W * W + 6 * W
    else:
        flops = 2 * 2 * rows * W * 4 * W
        weights = 8 * W * W + 7 * W
    return flops, (2 * rows * W + weights) * elt


def phase_times(torch):
    import torch.nn.functional as F

    from evr_tpu_torch.ops import block_fused as bf

    dev = torch.device("cuda")
    out = {}
    for shape_name, s in (("vision", VISION), ("text", TEXT)):
        gen = torch.Generator(device=dev).manual_seed(2)
        attn_args, mlp_args = bf.block_half_params(block_params(torch, s["W"], gen, dev))
        dt = torch.bfloat16
        x = unit_activations(torch, (s["B"], s["T"], s["W"]), gen, dev).to(dt)
        a = [t.to(dt) for t in attn_args]
        m = [t.to(dt) for t in mlp_args]
        B, T, W, H = s["B"], s["T"], s["W"], s["H"]
        qkv_t, out_t = a[2].t().contiguous(), a[4].t().contiguous()
        fc_t, pr_t = m[2].t().contiguous(), m[4].t().contiguous()

        def lib_attn():
            y = F.layer_norm(x, (W,), a[0], a[1], 1e-5)
            q, k, v = F.linear(y, qkv_t, a[3]).view(B, T, 3, H, W // H).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(q, k, v, is_causal=s["causal"])
            return x + F.linear(o.transpose(1, 2).reshape(B, T, W), out_t, a[5])

        def lib_mlp():
            h = F.linear(F.layer_norm(x, (W,), m[0], m[1], 1e-5), fc_t, m[3])
            return x + F.linear(h * torch.sigmoid(1.702 * h), pr_t, m[5])

        cases = (
            ("fused_attn_block", lambda: bf.fused_attn_block(x, *a, n_heads=H, causal=s["causal"]),
             lambda: bf.fused_attn_block_plain(x, *a, n_heads=H, causal=s["causal"]), lib_attn),
            ("fused_mlp_block", lambda: bf.fused_mlp_block(x, *m),
             lambda: bf.fused_mlp_block_plain(x, *m), lib_mlp),
        )
        saved = (bf.fused_attn_block.launches, bf.fused_mlp_block.launches)
        for name, kern, plain, lib in cases:
            # parent order plain, kernel, kernel, plain: the pairs share a clock
            p1, k1, k2, p2 = (cuda_ms(torch, f) for f in (plain, kern, kern, plain))
            lib_ms = cuda_ms(torch, lib)
            flops, nbytes = half_costs(name, s, 2)
            t_ops, t_bytes = flops / H100_BF16_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
            rec = {
                "ms": min(k1, k2), "plain_ms": min(p1, p2), "library_ms": lib_ms,
                "bound_ms": max(t_ops, t_bytes),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "gflop": flops / 1e9, "mbytes": nbytes / 1e6,
            }
            out[(name, shape_name)] = rec
            log(f"time {name} {shape_name} bf16: kernel {k1:.4f}/{k2:.4f} ms, plain "
                f"{p1:.4f}/{p2:.4f} ms, library {lib_ms:.4f} ms, bound {rec['bound_ms']:.4f} ms "
                f"({rec['bound_by']}: {rec['gflop']:.2f} GFLOP, {rec['mbytes']:.1f} MB)")
        # timing launches are not main-path launches
        bf.fused_attn_block.launches, bf.fused_mlp_block.launches = saved
    return out


# -- main --------------------------------------------------------------------


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU", file=sys.stderr)
        return 2
    try:
        import evr_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the evr_tpu_torch package is missing ({e})", file=sys.stderr)
        return 2
    card = card_line()
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        phase_build()
        worst = phase_parity(torch)
        main = phase_main_path(torch)
        times = phase_times(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"main path: encode {main['encode_frames_per_s']:.1f} frames/s "
        f"(bf16, batch {BATCH}, {N_FRAMES} frames), text query p50 "
        f"{main['text_query_p50_ms']:.2f} ms, /api/search p50 {main['request_p50_ms']:.2f} ms")
    sources = {"fused_attn_block": ("evr_tpu_torch/ops/csrc/block_attn.cu",
                                    "evr_tpu/ops/block_fused.py:340"),
               "fused_mlp_block": ("evr_tpu_torch/ops/csrc/block_mlp.cu",
                                   "evr_tpu/ops/block_fused.py:1038")}
    kernels = []
    for name, (src, replaces) in sources.items():
        t = times[(name, "vision")]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": main["launches"][name], "max_abs_err": worst[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        })
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
