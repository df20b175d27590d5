"""The port's kernel build: nvcc targets Hopper (``sm_90a``) and a built
library is keyed by its sources, so an edited kernel is rebuilt. The build
itself needs ``nvcc`` and runs on the card (``chip_smoke.py``)."""

from evr_tpu_torch.ops import build


def test_build_targets_hopper_and_tracks_sources(tmp_path, monkeypatch):
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-shared" in flags
    for name in build.KERNEL_SOURCES:
        assert (build.CSRC / f"{name}.cu").exists()
    # the library name follows the sources: an edited kernel is rebuilt
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in build.CSRC.iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    before = build.library_path("block_attn")
    (csrc / "block_attn.cu").write_text((csrc / "block_attn.cu").read_text() + "\n// edit\n")
    assert build.library_path("block_attn") != before
