"""PyTorch port, the training step's global-norm clip (`ops/cuda_clip.py`)
on the CPU.

The kernels' leaf tables are checked in plain Python: the padded prefix
offsets, the tails, the float4 choice by base address, the grid, the split
past one table's capacity, and, walked block by block as
`csrc/clip_norm.cu::walk` walks them, that every float of every leaf is
read exactly once and by float4 only where the kernel may. The wrapper's
CPU route is the plain version, which holds to optax below and above the
norm; a CPU `Trainer` step records the path; the kernel route (the device
check and the launch faked) refuses a gradient that is not float32 or not
contiguous before it launches.
"""
import numpy as np
import optax
import pytest
import torch

from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.data.datasets import YamahaDataset
from music_fader_nets_tpu_torch.models.gmvae import init_reg_gmvae
from music_fader_nets_tpu_torch.ops import cuda_clip, cuda_gru
from music_fader_nets_tpu_torch.train import clip_norm
from music_fader_nets_tpu_torch.train.objectives import gmm_loss
from music_fader_nets_tpu_torch.train.profile import random_corpus
from music_fader_nets_tpu_torch.train.trainer import Trainer

C = cuda_clip


def _fields(t):
    k = int(t[0])
    return {"n": k, "blocks": int(t[1]), "chunk": int(t[2]),
            "part_base": int(t[3]),
            "offset": t[C._OFFSET: C._OFFSET + k + 1].tolist(),
            "numel": t[C._NUMEL: C._NUMEL + k].tolist(),
            "ptr": t[C._PTR: C._PTR + k].tolist(),
            "vec": t[C._VEC: C._VEC + k].tolist()}


def _walk(f):
    """{(ptr, index): reads} and the float4 reads [(ptr, index)] of every
    block of one table, as the kernel's `walk` takes them."""
    reads, vec_reads = {}, []
    total = f["offset"][-1]
    for b in range(f["blocks"]):
        start = b * f["chunk"]
        stop = min(start + f["chunk"], total)
        for leaf in range(f["n"]):
            lo_l, hi_l = f["offset"][leaf], f["offset"][leaf + 1]
            if hi_l <= start or lo_l >= stop:
                continue
            lo, hi = max(start, lo_l) - lo_l, min(stop, hi_l) - lo_l
            p, n = f["ptr"][leaf], f["numel"][leaf]
            for i in range(lo, hi, 4):
                if f["vec"][leaf] and i + 4 <= n:
                    vec_reads.append((p, i))
                    idx = range(i, i + 4)
                else:
                    idx = range(i, min(i + 4, n))
                for j in idx:
                    reads[(p, j)] = reads.get((p, j), 0) + 1
    return reads, vec_reads


# (leaves [(address, numel)], SMs, what the first table must hold)
_CASES = {
    "tails_and_alignment": (
        [(0x10000, 7), (0x10104, 8), (0x20000, 3), (0x30000, 0),
         (0x40008, 1000), (0x50000, 1)], 2,
        {"offset": [0, 8, 16, 20, 20, 1020, 1024],
         "vec": [1, 0, 1, 1, 0, 1], "part_base": 0}),
    "one_long_leaf": ([(0x100000, 100_003)], 2,
                      {"offset": [0, 100_004], "vec": [1], "blocks": 16}),
    "past_one_table": (
        [(0x100000 + 4096 * i, 1 + (37 * i) % 301) for i in range(300)], 4,
        {"n": C.TABLE_LEAVES}),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_leaf_tables(case):
    leaves, sms, want = _CASES[case]
    tables, n_partials = C.leaf_tables(leaves, sms)
    assert len(tables) == -(-len(leaves) // C.TABLE_LEAVES)
    assert all(t.dtype == np.int64 and t.shape == (C.TABLE_WORDS,)
               for t in tables)
    first = _fields(tables[0])
    assert {k: first[k] for k in want} == want
    base, seen = 0, {}
    for j, t in enumerate(tables):
        f = _fields(t)
        part = leaves[j * C.TABLE_LEAVES: (j + 1) * C.TABLE_LEAVES]
        assert f["ptr"] == [p for p, _ in part]
        assert f["numel"] == [n for _, n in part]
        assert f["vec"] == [int(p % 16 == 0) for p, _ in part]
        pad = [-(-n // 4) * 4 for _, n in part]
        assert f["offset"] == [0] + np.cumsum(pad).tolist()
        assert f["part_base"] == base
        total = f["offset"][-1]
        assert f["chunk"] % 4 == 0 and f["chunk"] >= 4
        assert 1 <= f["blocks"] <= sms * C.BLOCKS_PER_SM
        assert (f["blocks"] - 1) * f["chunk"] < max(total, 1)
        assert f["blocks"] * f["chunk"] >= total
        base += f["blocks"]
        reads, vec_reads = _walk(f)
        assert all(p % 16 == 0 and i % 4 == 0 for p, i in vec_reads)
        for key, r in reads.items():
            seen[key] = seen.get(key, 0) + r
    assert n_partials == base
    assert seen == {(p, i): 1 for p, n in leaves for i in range(n)}


def test_leaf_tables_of_the_training_trees():
    """The GM-VAE's 43 leaves (two of a numel not a multiple of 4, the
    smallest 3 floats) and the CVAE's 21 fit one table each."""
    for family, n, floats, odd, smallest in (
            ("gmvae", 43, 12_172_905, 2, 3), ("cvae", 21, 6_418_518, 1, 128)):
        sizes = [int(np.prod(s)) for s in clip_norm.tree_shapes(family)]
        assert (len(sizes), sum(sizes), min(sizes)) == (n, floats, smallest)
        assert sum(s % 4 != 0 for s in sizes) == odd
        tables, n_partials = C.leaf_tables(
            [(16 * (i + 1), s) for i, s in enumerate(sizes)], 132)
        assert len(tables) == 1 and tables[0][1] == n_partials
        assert n_partials <= 132 * C.BLOCKS_PER_SM


@pytest.mark.parametrize("scale", [0.01, 10.0])
def test_clip_cpu_route_matches_plain_and_optax(scale):
    rng = np.random.default_rng(7)
    tree = {"a": (rng.standard_normal((7, 3)) * scale).astype(np.float32),
            "b": (rng.standard_normal(11) * scale).astype(np.float32),
            "c": (rng.standard_normal(3) * scale).astype(np.float32)}
    want, _ = optax.clip_by_global_norm(1.0).update(tree, None)
    got = [torch.from_numpy(tree[k].copy()) for k in sorted(tree)]
    plain = [g.clone() for g in got]
    cuda_clip.LAST_CLIP_PATH = None
    norm = cuda_clip.clip_global_norm_(got, 1.0)
    assert cuda_clip.LAST_CLIP_PATH == "plain-cpu"
    assert torch.equal(norm, cuda_clip.clip_by_global_norm_(plain, 1.0))
    assert (float(norm) > 1.0) == (scale > 1.0)
    for g, p, k in zip(got, plain, sorted(tree)):
        assert torch.equal(g, p)
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0)
    assert float(cuda_clip.clip_global_norm_([], 1.0)) == 0.0


def test_trainer_records_the_clip_path_on_the_cpu():
    cfg = ModelConfig(hidden_dims=32, z_dims=8, seq_len=8, attr_len=4)
    tr = Trainer(cfg, init_reg_gmvae, {"default": gmm_loss}, device="cpu")
    assert tr.clip_path is None
    arrays = YamahaDataset(*random_corpus(cfg, 5, 1), mode="train").arrays()
    tr.run_epoch(arrays, batch_size=4)
    assert tr.clip_path == "plain-cpu" and tr.train_path == "plain-cpu"


@pytest.mark.parametrize("bad", [None, torch.bfloat16, torch.float16,
                                 torch.float64, "strided"])
def test_kernel_route_takes_only_contiguous_float32(monkeypatch, bad):
    """With the device check faked to a card and the launch stubbed: a
    float32 tree launches once and records the kernel path; a gradient of
    another dtype raises TypeError, a strided one ValueError, and neither
    launches nor falls back to the plain version."""
    calls = []

    def launch(grads, max_norm, dev):
        calls.append((len(grads), max_norm, dev))
        return torch.zeros(())

    monkeypatch.setattr(cuda_gru, "kernel_device",
                        lambda ts: torch.device("cuda", 0))
    monkeypatch.setattr(cuda_clip, "_launch", launch)
    monkeypatch.setattr(cuda_clip, "clip_by_global_norm_", None)
    grads = [torch.ones(5), torch.ones((3, 4))]
    if bad == "strided":
        grads[1] = grads[1].t()
    elif bad is not None:
        grads[1] = grads[1].to(bad)
    before = dict(cuda_clip.LAUNCHES)
    cuda_clip.LAST_CLIP_PATH = None
    if bad is None:
        cuda_clip.clip_global_norm_(grads, 1.0)
        assert calls == [(2, 1.0, torch.device("cuda", 0))]
        assert cuda_clip.LAST_CLIP_PATH == "kernel"
        assert cuda_clip.LAUNCHES == {k: v + 1 for k, v in before.items()}
        return
    with pytest.raises(TypeError if bad != "strided" else ValueError):
        cuda_clip.clip_global_norm_(grads, 1.0)
    assert calls == [] and cuda_clip.LAST_CLIP_PATH is None
    assert cuda_clip.LAUNCHES == before
