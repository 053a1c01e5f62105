"""The port's training data pipeline, k-means codebook init, ZeRO rule and
checkpoint retention against the JAX package's (taste_spokenlm_tpu_torch
data/dataset.py, models/quantizer.py, parallel/mesh.py,
utils/checkpoint.py).

The batching runs on the examples of tests/test_data.py through both
packages, array for array; the stage-1 and flow datasets read one arrow
shard written with `datasets`, the stage-2 one a jsonl file.  K-means takes
the first centroids JAX draws (threefry cannot be replayed in torch).
"""

import functools
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu.data import dataset as jax_data
from taste_spokenlm_tpu.models import quantizer as jax_quantizer
from taste_spokenlm_tpu.parallel import mesh as jax_mesh
from taste_spokenlm_tpu_torch.config import QuantizerConfig, TasteConfig
from taste_spokenlm_tpu_torch.data import dataset as data
from taste_spokenlm_tpu_torch.models.quantizer import ResidualVQ, kmeans
from taste_spokenlm_tpu_torch.parallel import mesh
from taste_spokenlm_tpu_torch.utils.checkpoint import CheckpointManager

from torch_parity_common import rel_err, t
from test_data import _example

MEL_TOL = 1e-4        # the whisper log-mels, f32 FFTs on either side
# the flow's natural-log mel: near its 1e-5 floor (the resampled band edge)
# f32 rounding moves the log by ~1e-3, so it is held in the linear domain,
# relative to the largest value
FLOW_MEL_TOL = 1e-5
KMEANS_TOL = 1e-5


def assert_batches_equal(got, ref):
    got, ref = list(got), list(ref)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            assert g[k].dtype == r[k].dtype, k
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


# ---------------------------------------------------------------------------
# batching: the cases of tests/test_data.py, through both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hosts", [1, 2, 3])
def test_shard_files_match_jax(hosts):
    files = [f"shard-{i}" for i in (3, 1, 4, 0, 9, 2, 6, 5, 8, 7)]
    for h in range(hosts):
        assert data.shard_files(files, h, hosts) == \
            jax_data.shard_files(files, h, hosts)


@pytest.mark.parametrize("sizes", [(20, 30, 100), (40, 60, 300),
                                   (200, 10, 10), (96, 144, 768),
                                   (97, 10, 10)])
def test_pick_bucket_matches_jax(sizes):
    ex = _example(*sizes)
    assert data.pick_bucket(ex, data.DEFAULT_BUCKETS) == \
        jax_data.pick_bucket(ex, jax_data.DEFAULT_BUCKETS)


@pytest.mark.parametrize("budget", [512, 2048])
def test_batcher_and_collate_match_jax(budget):
    """Mixed lengths, an overlong example, the flushed tail: the same
    buckets, groups and padded arrays."""
    sizes = [(20, 30, 100), (40, 60, 300), (20, 30, 100), (500, 500, 5000),
             (90, 100, 700), (20, 30, 250), (40, 60, 300), (10, 12, 50)]
    examples = [_example(*s, seed=i) for i, s in enumerate(sizes)]
    ours, theirs = (data.BucketBatcher(token_budget=budget),
                    jax_data.BucketBatcher(token_budget=budget))

    def run(mod, batcher):
        out = [mod.collate(g, b, mel_frames=500) for b, g in
               batcher(examples)]
        return out + [mod.collate(g, b, mel_frames=500) for b, g in
                      batcher.flush()]
    assert_batches_equal(run(data, ours), run(jax_data, theirs))
    assert ours.n_dropped == theirs.n_dropped == 1
    assert ours.batch_sizes == theirs.batch_sizes


def test_collate_audio_samples_match_jax():
    """The mel_on_device layout: raw samples padded to the mel window."""
    examples = []
    for i, n in enumerate((16000, 40000)):
        ex = _example(20, 30, 100, seed=i)
        del ex["audio_features"]
        ex["audio_samples"] = np.random.RandomState(i).randn(n).astype("f4")
        ex["audio_feature_lengths"] = n // 160
        examples.append(ex)
    bucket = data.BucketSpec(32, 48, 256)
    got = data.collate(examples, bucket, mel_frames=300)
    ref = jax_data.collate(examples, jax_data.BucketSpec(32, 48, 256),
                           mel_frames=300)
    assert_batches_equal([got], [ref])
    assert got["audio_samples"].shape == (2, 300 * 160)


def test_stage2_jsonl_dataset_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    rows = [{"llm_indices": rng.randint(0, 32, (n, 4)).tolist(),
             "llm_token_ids": rng.randint(1, 100, (n,)).tolist(),
             "llm_word_ids": (np.arange(n) // 2).tolist()}
            for n in (5, 7, 40, 60, 100, 300, 3, 8)]
    files = []
    for i in range(2):
        f = tmp_path / f"part-{i}.jsonl"
        f.write_text("\n".join(json.dumps(r) for r in rows[i::2]))
        files.append(str(f))
    for host in range(2):
        kw = dict(host_index=host, host_count=2, seed=3,
                  llm_buckets=(8, 48, 128), token_budget=128)
        ours = data.Stage2JsonlDataset(files, **kw)
        theirs = jax_data.Stage2JsonlDataset(files, **kw)
        for epoch in range(2):
            assert_batches_equal(ours.batches(epoch), theirs.batches(epoch))
        assert ours.n_dropped == theirs.n_dropped


# ---------------------------------------------------------------------------
# the arrow datasets: one TASTE-Dump-style shard
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def arrow_shard(tmp_path_factory):
    datasets = pytest.importorskip("datasets")
    r = np.random.RandomState(0)
    rows = {"mp3": [], "json": [], "s3_token": [], "spk_emb": []}
    for i, (sr, secs, n_tok) in enumerate(((24000, 1.3, 30), (16000, 0.9, 60),
                                           (22050, 2.1, 100),
                                           (24000, 0.6, 300))):
        tt = np.arange(int(sr * secs)) / sr
        wav = (0.3 * np.sin(2 * np.pi * (180 + 40 * i) * tt)
               + 0.02 * r.randn(tt.size)).astype(np.float32)
        rows["mp3"].append({"array": wav, "sampling_rate": sr})
        rows["json"].append({"text": " ".join(["word"] * (3 + i))})
        rows["s3_token"].append(r.randint(0, 4096, n_tok).tolist())
        rows["spk_emb"].append(r.randn(192).astype(np.float32))
    d = tmp_path_factory.mktemp("arrow")
    datasets.Dataset.from_dict(rows).save_to_disk(str(d))
    return [str(p) for p in sorted(d.glob("*.arrow"))]


def _tokenize(text):
    n = len(text.split())
    ids = np.arange(5, 5 + 2 * n, dtype=np.int32)
    words = np.arange(2 * n, dtype=np.int32) // 2
    return {"asr_token_ids": ids, "asr_word_ids": words,
            "llm_token_ids": ids[:n + 1], "llm_word_ids": words[:n + 1],
            "asr_token_lengths": np.array([2 * n])}


def _assert_close_batches(got, ref, float_keys):
    got, ref = list(got), list(ref)
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k in r:
            assert g[k].shape == r[k].shape, k
            if k == "feat":
                assert rel_err(np.exp(g[k]), np.exp(r[k])) <= FLOW_MEL_TOL
            elif k in float_keys:
                assert np.max(np.abs(g[k] - np.asarray(r[k]))) <= MEL_TOL, k
            else:
                np.testing.assert_array_equal(g[k], r[k], err_msg=k)


@pytest.mark.parametrize("mel_on_device", [False, True])
def test_stage1_dataset_matches_jax(arrow_shard, mel_on_device):
    """Resample to 16 kHz, the whisper log-mel (or the raw samples), the
    tokenize hook, buckets: JAX's batches from the same shard."""
    w = TasteConfig.tiny().audio_tower.whisper
    kw = dict(tokenize_fn=_tokenize, seed=1, token_budget=512,
              n_mels=w.n_mels, mel_frames=2 * w.max_source_positions,
              mel_on_device=mel_on_device)
    ours = data.Stage1Dataset(arrow_shard, **kw)
    theirs = jax_data.Stage1Dataset(arrow_shard, **kw)
    key = "audio_samples" if mel_on_device else "audio_features"
    _assert_close_batches(ours.batches(0), theirs.batches(0), {key})


def test_flow_dataset_matches_jax(arrow_shard):
    """Resample to 22.05 kHz, the CosyVoice mel, the x-vector's norm,
    (token, frame) buckets with one overlong row dropped."""
    kw = dict(seed=2, token_buckets=(64, 128), token_budget=256)
    ours = data.FlowDataset(arrow_shard, **kw)
    theirs = jax_data.FlowDataset(arrow_shard, **kw)
    _assert_close_batches(ours.batches(0), theirs.batches(0),
                          {"feat", "embedding"})
    assert ours.n_dropped == theirs.n_dropped == 1


# ---------------------------------------------------------------------------
# k-means codebook init, on JAX's first centroids
# ---------------------------------------------------------------------------


def _jax_choice(key, n, k):
    return np.asarray(jax.random.choice(key, n, (k,), replace=n < k))


@pytest.mark.parametrize("n, weighted", [(200, False), (200, True),
                                         (12, False)])
def test_kmeans_matches_jax(n, weighted):
    """Clustered points (and N < K, drawn with replacement), with and
    without sample weights."""
    r = np.random.RandomState(0)
    centers = r.randn(4, 8) * 3
    pts = (centers[r.randint(0, 4, n)] + 0.5 * r.randn(n, 8)).astype("f4")
    weight = (0.5 + r.rand(n)).astype("f4") if weighted else None
    k, iters, key = 16, 10, jax.random.PRNGKey(3)
    c_ref, s_ref = jax_quantizer.kmeans(
        key, jnp.asarray(pts), k, iters,
        None if weight is None else jnp.asarray(weight))
    c, s = kmeans(t(pts), k, iters, sample_weight=(
        None if weight is None else t(weight)),
        init_idx=t(_jax_choice(key, n, k)))
    assert rel_err(c.numpy(), c_ref) <= KMEANS_TOL
    assert rel_err(s.numpy(), s_ref) <= KMEANS_TOL


@pytest.mark.parametrize("kmeans_init", [True, False])
def test_init_codebook_state_matches_jax(kmeans_init):
    """Every level's codebook from the residual the levels before leave:
    the four buffers against JAX's "quantizer" collection (without
    kmeans_init, the draws differ by generator; shapes and sizes only)."""
    cfg = QuantizerConfig.tiny().replace(kmeans_init=kmeans_init,
                                         kmeans_iters=6, num_quantizers=3)
    from taste_spokenlm_tpu.config import QuantizerConfig as JaxQCfg
    mod = jax_quantizer.ResidualVQ(JaxQCfg(**cfg.to_dict()))
    r = np.random.RandomState(1)
    samples = (r.randn(300, cfg.codebook_dim) * 2).astype("f4")
    x0 = jnp.zeros((1, 2, cfg.dim))
    variables = jax.tree.map(lambda a: jnp.zeros(a.shape, a.dtype),
                             jax.eval_shape(mod.init, jax.random.PRNGKey(0),
                                            x0))
    key = jax.random.PRNGKey(7)
    ref = jax.jit(functools.partial(
        mod.apply, method=jax_quantizer.ResidualVQ.init_codebook_state))(
        variables, key, jnp.asarray(samples))
    init_idx, rng = [], key
    for _ in range(cfg.num_quantizers):
        rng, sub = jax.random.split(rng)
        init_idx.append(_jax_choice(sub, samples.shape[0], cfg.codebook_size))
    port = ResidualVQ(cfg)
    port.init_codebook_state(t(samples), torch.Generator().manual_seed(0),
                             init_idx=t(np.stack(init_idx)))
    for name in ("embed", "embed_avg", "cluster_size"):
        got = np.stack([getattr(lv._codebook, name)[0].numpy()
                        for lv in port.layers])
        assert got.shape == np.asarray(ref[name]).shape, name
        if kmeans_init:
            assert rel_err(got, ref[name]) <= KMEANS_TOL, name
    if not kmeans_init:
        assert (port.layers[0]._codebook.cluster_size == 1).all()
    assert all(bool(lv._codebook.initted.all()) for lv in port.layers)


# ---------------------------------------------------------------------------
# the ZeRO rule and the checkpoint retention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [1, 2, 3, 4, 8])
def test_zero_shard_rule_matches_jax(world):
    fake = types.SimpleNamespace(shape={"data": world})
    for shape in ((), (7,), (8,), (16, 64), (64, 16), (64, 64), (3, 5),
                  (12, 8, 6), (4096, 1280), (1, 8), (6, 9)):
        spec = tuple(jax_mesh.zero_shard_rule(shape, fake))
        want = spec.index("data") if "data" in spec else None
        assert mesh.zero_shard_rule(shape, world) == want, (shape, world)


@pytest.mark.parametrize("max_to_keep, best, mode", [
    (2, "loss", "min"), (3, "loss", "max"), (2, None, "min"),
    (None, "loss", "min"), (1, "loss", "min")])
def test_checkpoint_retention_matches_orbax(tmp_path, max_to_keep, best,
                                            mode):
    """One save sequence (ties, a step with no metrics, a repeated step)
    through both managers: the kept, latest and best steps after each."""
    from taste_spokenlm_tpu.utils.checkpoint import \
        CheckpointManager as OrbaxManager
    ours = CheckpointManager(str(tmp_path / "ours"), max_to_keep, best, mode)
    theirs = OrbaxManager(str(tmp_path / "orbax"), max_to_keep, best, mode)
    saves = [(1, 3.0), (2, 1.0), (3, None), (4, 2.0), (4, 0.5), (5, 1.0),
             (6, 5.0), (8, 0.25)]
    for step, loss in saves:
        metrics = None if loss is None else {"loss": loss}
        state = {"w": np.full((2,), step, np.float32)}
        ours.save(step, {"w": torch.from_numpy(state["w"])}, metrics)
        theirs.save(step, state, metrics)
        theirs.wait()
        assert ours.all_steps() == list(theirs._mgr.all_steps()), step
        assert ours.latest_step() == theirs.latest_step(), step
        assert ours.best_step() == theirs.best_step(), step
    latest = ours.latest_step()
    assert float(ours.restore()["w"][0]) == latest
    theirs.close()
