"""Binary embedding shards: the production storage of a segment index.

Port of ``videoquery/index/persist.py`` with its format: a directory of
``shard_NNNNN.vqidx.npz`` files, each holding the dense block ``feats``
[S, K, n, D], ``mask`` [S, K, n] and ``clip_ids`` [n] of a run of clips,
and a ``manifest.json`` naming the shards, streams, splits, feature name
and width, clip count and the feature dtype. Shards written by either
package load in the other.

A bfloat16 block is stored as numpy stores an ``ml_dtypes`` bfloat16 array:
raw 2-byte void items (``V2``). The manifest's ``"dtype"`` says what they
are, so this module reads them as ``torch.bfloat16`` without ml_dtypes.
(The JAX package's own loader cannot read a bf16 shard: ``jnp.asarray``
refuses ``V2``.)
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from videoquery_torch.core.device import resolve_device
from videoquery_torch.index.store import FeatureIndex

FORMAT_VERSION = 1


def _feats_to_numpy(feats: torch.Tensor) -> np.ndarray:
    """The host array save_index writes: float32 as is, bfloat16 as its raw
    2-byte items."""
    feats = feats.detach().cpu().contiguous()
    if feats.dtype == torch.bfloat16:
        return feats.view(torch.int16).numpy().view(np.dtype("V2"))
    return feats.numpy()


def _feats_from_numpy(feats: np.ndarray, dtype_name: str) -> torch.Tensor:
    """The features of a shard as a tensor of the manifest's dtype."""
    if dtype_name not in ("float32", "bfloat16"):
        raise ValueError(f"unsupported shard dtype {dtype_name!r}")
    if dtype_name == "bfloat16":
        if feats.dtype.itemsize != 2:
            raise ValueError(f"a bfloat16 shard holds 2-byte items, not {feats.dtype}")
        raw = np.ascontiguousarray(feats).view(np.int16)
        return torch.from_numpy(raw).view(torch.bfloat16)
    if feats.dtype != np.float32:
        raise ValueError(f"manifest says float32, the shard holds {feats.dtype}")
    return torch.from_numpy(np.ascontiguousarray(feats))


def save_index(index: FeatureIndex, directory: str,
               shard_clips: int = 65536) -> list[str]:
    """Write the index as one or more .vqidx.npz shards and a manifest."""
    os.makedirs(directory, exist_ok=True)
    feats = _feats_to_numpy(index.feats)
    mask = index.mask.detach().cpu().numpy()
    n = index.n_clips
    paths = []
    for shard_id, start in enumerate(range(0, n, shard_clips)):
        end = min(start + shard_clips, n)
        path = os.path.join(directory, f"shard_{shard_id:05d}.vqidx.npz")
        np.savez(path, feats=feats[:, :, start:end], mask=mask[:, :, start:end],
                 clip_ids=index.clip_ids[start:end])
        paths.append(path)
    manifest = {
        "version": FORMAT_VERSION,
        "streams": list(index.streams),
        "splits": list(index.splits),
        "feature_name": index.feature_name,
        "feature_dim": index.feature_dim,
        "n_clips": int(n),
        "shards": [os.path.basename(p) for p in paths],
        "dtype": str(index.feats.dtype).removeprefix("torch."),
    }
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return paths


def load_index_binary(directory: str, pad_multiple: int = 8,
                      dtype: torch.dtype | None = None, keep_host: bool = False,
                      device: torch.device | str | None = None) -> FeatureIndex:
    """Load a .vqidx shard directory into a FeatureIndex on
    ``resolve_device(device)``: the shards are joined and padded on the
    host and each tensor is copied to the device once. dtype (default: the
    manifest's) converts the features."""
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["version"] != FORMAT_VERSION:
        raise ValueError(f"unsupported index format v{manifest['version']}")
    feats_parts, mask_parts, id_parts = [], [], []
    for shard in manifest["shards"]:
        with np.load(os.path.join(directory, shard)) as z:
            feats_parts.append(z["feats"])
            mask_parts.append(z["mask"])
            id_parts.append(z["clip_ids"])
    feats = _feats_from_numpy(np.concatenate(feats_parts, axis=2), manifest["dtype"])
    mask = np.concatenate(mask_parts, axis=2)
    clip_ids = np.concatenate(id_parts)
    n = manifest["n_clips"]
    n_pad = -(-max(n, 1) // pad_multiple) * pad_multiple
    if n_pad != feats.shape[2]:
        pad = n_pad - feats.shape[2]
        feats = torch.nn.functional.pad(feats, (0, 0, 0, pad))
        mask = np.pad(mask, ((0, 0), (0, 0), (0, pad)))
    if dtype is not None:
        feats = feats.to(dtype)
    device = resolve_device(device)
    index = FeatureIndex(clip_ids, feats.to(device), torch.from_numpy(mask).to(device),
                         tuple(manifest["streams"]), tuple(manifest["splits"]),
                         manifest["feature_name"])
    if keep_host:
        index.host_feats = feats.double().numpy()
        index.host_mask = mask
    return index
