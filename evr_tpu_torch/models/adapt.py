"""Checkpoint adaptation across resolutions.

Counterpart of ``evr_tpu/models/adapt.py``: ``adapt_params_for_resolution``
loads a 224px checkpoint into a higher-resolution tower (the @336 variant in
the registry) by resampling the patch-position grid cubically, the way the
336px OpenAI checkpoint relates to the 224px one.
"""

from __future__ import annotations

import copy

from .clip import CLIPConfig, interpolate_pos_embedding


def adapt_params_for_resolution(params: dict, target_cfg: CLIPConfig) -> dict:
    """Params whose vision pos-embedding matches ``target_cfg``'s grid; the
    params themselves when it already does (so adapting twice is adapting
    once). Only the pos-embedding leaf is new; every other leaf is shared."""
    new_grid = target_cfg.vision.grid
    pos = params["visual"]["pos_embedding"]
    if pos.shape[0] == new_grid * new_grid + 1:
        return params
    out = copy.copy(params)
    out["visual"] = dict(params["visual"])
    out["visual"]["pos_embedding"] = interpolate_pos_embedding(pos, new_grid)
    return out
