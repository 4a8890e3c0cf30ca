"""The port's .vqidx shards (videoquery_torch.index.persist) and the loader's
--shard_out / --no_api against the JAX package's.

Ports of tests/test_index.py's shard round trip and query equivalence and
tests/test_service.py's loader CLI test, and shards crossing packages: an
f32 shard written by either package is the same file content (the npz
members' bytes) and loads in the other with the same bits; a bf16 shard
(numpy stores it as raw 2-byte ``V2`` items) written by the JAX package
loads in the port with the same bits, and the port writes the same items.
The JAX package's own loader cannot read a bf16 shard, its own or the
port's (``jnp.asarray`` refuses ``V2``): an inherited defect, pinned here.
"""

import json
import os
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_service import make_csv_tree
from videoquery.index import persist as jpersist
from videoquery.index.store import FeatureIndex as JaxIndex
from videoquery.index.store import FeatureRecord as JaxRecord
from videoquery.search.engine import SearchEngine as JaxEngine
from videoquery_torch.index import persist
from videoquery_torch.index.records import FeatureRecord
from videoquery_torch.index.store import FeatureIndex
from videoquery_torch.search.engine import SearchEngine
from videoquery_torch.service import loader

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)

STREAMS = ("rgb", "warped_optical_flow")
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def rows(rng, n_clips, splits, dim=16):
    return [(cid, s, k, rng.normal(size=dim)) for cid in range(1, n_clips + 1)
            for s in STREAMS for k in splits]


def port_index(rows_, dtype=torch.float32, **kw):
    return FeatureIndex.build([FeatureRecord(c, s, k, "global_pool", v) for c, s, k, v in rows_],
                              STREAMS, device="cpu", dtype=dtype, **kw)


def jax_index(rows_, dtype=jnp.float32, **kw):
    return JaxIndex.build([JaxRecord(c, s, k, "global_pool", v) for c, s, k, v in rows_],
                          STREAMS, dtype=dtype, **kw)


def bits(feats) -> np.ndarray:
    """The raw bits of f32 or bf16 features, a torch tensor or a (JAX or
    ml_dtypes) array."""
    if isinstance(feats, torch.Tensor):
        itype = torch.int16 if feats.dtype == torch.bfloat16 else torch.int32
        return feats.contiguous().view(itype).numpy()
    a = np.asarray(feats)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def members(directory) -> dict:
    """{shard file: {member: bytes}} and the manifest."""
    out = {}
    for name in sorted(os.listdir(directory)):
        if name.endswith(".vqidx.npz"):
            with zipfile.ZipFile(os.path.join(directory, name)) as z:
                out[name] = {m: z.read(m) for m in z.namelist()}
    with open(os.path.join(directory, "manifest.json")) as f:
        return out, json.load(f)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_binary_shard_roundtrip(tmp_path, rng, dtype):
    """Index -> .vqidx shards -> index, across shard boundaries."""
    tdt = DTYPES[dtype][0]
    index = port_index(rows(rng, 100, (1, 2)), tdt, feature_dim=16, pad_multiple=8)
    paths = persist.save_index(index, str(tmp_path / "idx"), shard_clips=32)
    assert len(paths) == 4  # 100 clips / 32 per shard
    back = persist.load_index_binary(str(tmp_path / "idx"), pad_multiple=8, device="cpu")
    assert back.n_clips == index.n_clips and back.n_padded == index.n_padded == 104
    assert (back.streams, back.splits, back.feature_name) == \
        (index.streams, index.splits, index.feature_name)
    assert back.feats.dtype == tdt
    np.testing.assert_array_equal(back.clip_ids, index.clip_ids)
    np.testing.assert_array_equal(bits(back.feats), bits(index.feats))
    np.testing.assert_array_equal(back.mask.numpy(), index.mask.numpy())


def test_binary_shard_query_equivalence(tmp_path, rng):
    """A query over the reloaded shards matches the original index, and a
    bf16 load of f32 shards equals the index built in bf16."""
    rows_ = rows(rng, 40, (1,))
    index = port_index(rows_, feature_dim=16)
    persist.save_index(index, str(tmp_path / "idx"), shard_clips=16)
    back = persist.load_index_binary(str(tmp_path / "idx"), device="cpu", keep_host=True)
    np.testing.assert_array_equal(back.host_feats, index.feats.double().numpy())
    target = {s: {1: rng.normal(size=16).tolist()} for s in STREAMS}
    w = {"rgb": 1.0, "warped_optical_flow": 1.5}
    s1 = SearchEngine(index).compute_similarities(target).scores(w)
    s2 = SearchEngine(back).compute_similarities(target).scores(w)
    assert s1.keys() == s2.keys()
    for c in s1:
        np.testing.assert_allclose(s1[c], s2[c], rtol=1e-6)
    b16 = persist.load_index_binary(str(tmp_path / "idx"), dtype=torch.bfloat16, device="cpu")
    np.testing.assert_array_equal(bits(b16.feats), bits(port_index(rows_, torch.bfloat16).feats))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_jax_shards_load_in_the_port(tmp_path, rng, dtype):
    """Shards the JAX package wrote load in the port with the same bits."""
    want = jax_index(rows(rng, 50, (1, 2, 3)), DTYPES[dtype][1])
    jpersist.save_index(want, str(tmp_path / "jax"), shard_clips=20)
    got = persist.load_index_binary(str(tmp_path / "jax"), device="cpu")
    assert got.feats.dtype == DTYPES[dtype][0]
    np.testing.assert_array_equal(got.clip_ids, want.clip_ids)
    np.testing.assert_array_equal(bits(got.feats), bits(want.feats))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert (got.streams, got.splits) == (want.streams, want.splits)


def test_port_f32_shards_are_the_jax_files_and_load_there(tmp_path, rng):
    """The port's f32 shards hold the JAX package's bytes, member for
    member, with the same manifest; the JAX loader reads them."""
    rows_ = rows(rng, 50, (1, 2))
    persist.save_index(port_index(rows_), str(tmp_path / "port"), shard_clips=20)
    jpersist.save_index(jax_index(rows_), str(tmp_path / "jax"), shard_clips=20)
    assert members(tmp_path / "port") == members(tmp_path / "jax")
    back = jpersist.load_index_binary(str(tmp_path / "port"))
    np.testing.assert_array_equal(bits(back.feats), bits(port_index(rows_).feats))
    np.testing.assert_array_equal(back.clip_ids, port_index(rows_).clip_ids)


def test_port_bf16_shards_hold_the_jax_items(tmp_path, rng):
    """A bf16 index (the same bits in both packages) saved by each: the
    same manifest and the same raw 2-byte items, mask and clip ids (numpy
    heads the port's feats member '|V2', an ml_dtypes array '<V2'). The
    JAX loader refuses both alike."""
    want = jax_index(rows(rng, 30, (1,)), jnp.bfloat16)
    index = FeatureIndex.from_numpy(want.clip_ids, np.asarray(want.feats),
                                    np.asarray(want.mask), want.streams, want.splits,
                                    want.feature_name, device="cpu", dtype=torch.bfloat16)
    persist.save_index(index, str(tmp_path / "port"), shard_clips=16)
    jpersist.save_index(want, str(tmp_path / "jax"), shard_clips=16)
    got_m, want_m = members(tmp_path / "port"), members(tmp_path / "jax")
    assert got_m[1] == want_m[1] and got_m[1]["dtype"] == "bfloat16"
    for shard in want_m[0]:
        with np.load(tmp_path / "port" / shard) as a, np.load(tmp_path / "jax" / shard) as b:
            assert a["feats"].dtype.kind == b["feats"].dtype.kind == "V"
            assert a["feats"].tobytes() == b["feats"].tobytes()
            np.testing.assert_array_equal(a["mask"], b["mask"])
            np.testing.assert_array_equal(a["clip_ids"], b["clip_ids"])
    for d in ("port", "jax"):
        with pytest.raises(TypeError):
            jpersist.load_index_binary(str(tmp_path / d))


def test_loader_cli_shard_out_no_api(tmp_path, rng, monkeypatch):
    """loader --shard_out --no_api builds binary shards with no API client
    (and no device: the index is built on the host); they equal the JAX
    loader's shards of the same tree."""
    from videoquery.service import loader as jloader

    root = make_csv_tree(tmp_path, rng)
    monkeypatch.delenv("VIDEOQUERY_DEVICE", raising=False)
    loader.main([root, "--shard_out", str(tmp_path / "shards"), "--no_api"])
    idx = persist.load_index_binary(str(tmp_path / "shards"), device="cpu")
    assert idx.n_clips == 6
    assert idx.splits == (1, 2)
    jloader.main([root, "--shard_out", str(tmp_path / "jax"), "--no_api"])
    assert members(tmp_path / "shards") == members(tmp_path / "jax")
    want = loader.load_index(root, device="cpu")
    np.testing.assert_array_equal(bits(idx.feats), bits(want.feats))
    np.testing.assert_array_equal(idx.mask.numpy(), want.mask.numpy())


def test_jax_engine_scores_port_shards_as_its_own(tmp_path, rng):
    """The JAX search engine on the port's shards scores as on its own
    index."""
    rows_ = rows(rng, 24, (1,))
    persist.save_index(port_index(rows_), str(tmp_path / "idx"), shard_clips=10)
    back = jpersist.load_index_binary(str(tmp_path / "idx"))
    target = {s: {1: rng.normal(size=16).tolist()} for s in STREAMS}
    w = {"rgb": 1.0, "warped_optical_flow": 1.5}
    s1 = JaxEngine(jax_index(rows_)).compute_similarities(target).scores(w)
    s2 = JaxEngine(back).compute_similarities(target).scores(w)
    assert s1 == s2
