"""The port's model axis on the CPU at TasteConfig.tiny(), f32, against the
JAX package's (taste_spokenlm_tpu_torch/parallel/mesh.py, models/llama.py,
ops/quantized.py, quant.shard_state_dict, train/, utils/checkpoint.py,
entry.dryrun_multichip).

JAX runs in this process on its virtual 8-device CPU mesh
(make_mesh(data=4, model=2) for serving, (2, 2) for the stage-2 step).  The
port runs as gloo subprocesses, started together when the module starts:

* "tp": two ranks on a (1, 2) mesh: the bare Llama's forward (a prefill,
  two cached steps and the tied head) in the float layout with LoRA and its
  gradients, and in the int8 layout with the int8 embedding and head;
  `generate_completion` of the float model on two prompts; and in the int8
  serving layout (fused qkv held whole, the fused MLP on each rank's slice
  of the intermediate axis, the int4 head whole);
* "train 2x2" and "train 2x1": four ranks on a (2, 2) mesh and two on a
  (2, 1) mesh run two stage-1, two stage-2 (LoRA-only mask, chunked CE with
  the in-graph KL, JAX's eps) and two flow steps from the same weights on
  the same global batches of four rows; each saves its stage-1 state and
  restores the other's;
* `dryrun_multichip(4, device="cpu")`.

Tolerances: the rule table exactly; the Llama over two ranks against
JAX's sharded forward 2e-5 (last hidden states absolute, as
tests/test_quant.py's TP test; logits and gradients relative to the
reference's largest value: the ranks' partial sums add in another order);
trajectories exactly, with JAX's one retry on a second prompt
(tests/test_tp_serving.py: a reduction-order tie may flip one greedy step);
data x model against data-only 1e-5 relative to each tensor's largest
value, the ranks of a model group bit for bit; the stage-2 loss 1e-4
relative to JAX's step on the (2, 2) mesh.

Wall on one worker: about 45 s (the subprocesses overlap JAX's compiles).
"""

import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from taste_spokenlm_tpu.models.llama import LlamaModel as JaxLlama
from taste_spokenlm_tpu.models.sampler import SamplerConfig as JaxSamplerConfig
from taste_spokenlm_tpu.models.sampler import build_sampler_tables
from taste_spokenlm_tpu.models.taste import TasteForCausalLM as JaxTaste
from taste_spokenlm_tpu.parallel import mesh as jax_mesh
from taste_spokenlm_tpu.train import optim as jax_optim
from taste_spokenlm_tpu.train import train_step as jax_train_step
from taste_spokenlm_tpu.utils import quant as jq
from taste_spokenlm_tpu_torch import convert, quant
from taste_spokenlm_tpu_torch.config import TasteConfig
from taste_spokenlm_tpu_torch.entry import tiny_batch
from taste_spokenlm_tpu_torch.models.sampler import SamplerConfig
from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
from taste_spokenlm_tpu_torch.parallel import mesh

from torch_parity_common import (VocabScan, lm_inputs, quantize_variables_jax,
                                 rel_err, serving_config, t, tiny_pair)

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240              # seconds, each subprocess
FWD_TOL = 2e-5
DP_TOL = 1e-5
LOSS_TOL = 1e-4
MAX_STEPS = 16
SAMPLER = dict(delay=1, delay_level="word", text_top_p=0.0, taste_top_p=0.0,
               extra_words=4, has_prefix=True)
PROMPTS = (1, 8)           # lm_inputs seeds: the prompt and JAX's retry


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


WORKER = r"""
import os, sys, time
import numpy as np, torch, torch.distributed as dist
from taste_spokenlm_tpu_torch import quant
from taste_spokenlm_tpu_torch.config import TasteConfig
from taste_spokenlm_tpu_torch.models.flow import MaskedDiffWithXvec
from taste_spokenlm_tpu_torch.models.llama import LlamaModel
from taste_spokenlm_tpu_torch.models.sampler import SamplerConfig
from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
from taste_spokenlm_tpu_torch.parallel import mesh
from taste_spokenlm_tpu_torch.train import optim, train_step
from taste_spokenlm_tpu_torch.utils.checkpoint import CheckpointManager
torch.set_num_threads(1)
role, rank, world, port, tmp = sys.argv[1:6]
rank, world = int(rank), int(world)
mesh.init_distributed(f"localhost:{port}", world, rank)
d = torch.load(f"{tmp}/inputs.pt", weights_only=False)
cfg = TasteConfig.tiny()
out = {}

def llama_run(lm, ids, lens, nxt):
    full = lm(input_ids=ids, attention_lengths=lens)["last_hidden"]
    caches = lm.init_cache(2, 9)
    kv = torch.arange(9)[None, :] < lens[:, None]
    o = lm(input_ids=ids, caches=caches, cache_index=0, key_valid=kv)
    steps = [o["last_hidden"]]
    for s in range(2):
        kv = kv | (torch.arange(9) == 6 + s)[None, :]
        o = lm(input_ids=nxt[:, s:s + 1], caches=o["caches"],
               cache_index=6 + s, position_offset=lens + s, key_valid=kv)
        steps.append(o["last_hidden"])
    return full, steps, lm.logits(steps[-1])

if role == "tp":
    m = mesh.make_mesh(1, 2)
    ax = m.model_axis
    for layout, lcfg, lora in (
            ("float", cfg.spoken_lm.llama, cfg.spoken_lm.lora),
            ("int8", cfg.spoken_lm.llama.replace(
                quantized_serving="int8", quantized_embed_serving=True), None)):
        lm = LlamaModel(lcfg, lora, model_axis=ax)
        lm.load_state_dict(quant.shard_state_dict(d["llama_" + layout],
                                                  ax.rank, 2), strict=True)
        mesh.COLLECTIVES.clear()
        with torch.no_grad():
            full, steps, logits = llama_run(lm, d["ids"], d["lens"], d["nxt"])
        out[layout] = {"full": full, "steps": steps, "logits": logits,
                       "collectives": dict(mesh.COLLECTIVES)}
        if layout == "float":
            hid = lm(input_ids=d["ids"], attention_lengths=d["lens"])[
                "last_hidden"]
            loss = (hid * d["w_hidden"]).sum() + (
                lm.logits(hid) * d["w_logits"]).sum()
            loss.backward()
            out["grads"] = {n: p.grad for n, p in lm.named_parameters()}
    samp = SamplerConfig(**d["sampler"])
    for layout in ("float", "int8s"):
        c = cfg if layout == "float" else quant.serving_config(cfg, "int8")
        model = TasteForCausalLM(c, device="cpu", model_axis=ax).eval()
        model.load_state_dict(quant.shard_state_dict(d["taste_" + layout],
                                                     ax.rank, 2), strict=True)
        for seed, lm_in in d["prompts"].items():
            res = model.generate_completion(
                samp, d["tables"], lm_in["llm_indices"], lm_in["llm_token_ids"],
                lm_in["llm_token_lengths"], lm_in["llm_word_ids"],
                max_steps=d["max_steps"])
            out[f"gen_{layout}_{seed}"] = res
    # gloo on CUDA tensors: the gather built from all_reduce, on the CPU
    parts = (torch.arange(6.).reshape(2, 3) + 10 * rank,
             torch.tensor([True, rank == 1]), torch.arange(3) * (rank + 1))
    want = [mesh._all_gather(v) for v in parts]
    real, mesh._gloo_cuda = mesh._gloo_cuda, lambda x, group: True
    out["gather"] = (want, [mesh._all_gather(v) for v in parts])
    mesh._gloo_cuda = real
    out["bf16_sum"] = mesh._all_reduce(
        torch.full((1, 4), 1.5 + rank, dtype=torch.bfloat16))
else:
    data, model_ = (int(x) for x in role.split("x"))
    m = mesh.make_mesh(data, model_)
    out["place"] = (m.data_rank, m.model_rank)
    def local(b):
        return mesh.local_rows(b)
    def taste():
        model = TasteForCausalLM(cfg, device="cpu")
        model.load_state_dict(d["taste_float"], strict=True)
        return model.train()
    def stage1():
        model = taste()
        mask = optim.trainable_mask(model, optim.STAGE1_PHASES["rvq"])
        opt = optim.make_optimizer(model, 1e-3, mask=mask, grad_clip=1.0)
        return train_step.make_stage1_step(model, opt, trainable_mask=mask)
    step = stage1()
    out["stage1"] = [step(local(b)) for b in d["stage1"]]
    out["stage1_state"] = step.state.state_dict()
    own = f"{tmp}/ck_{role}"
    CheckpointManager(own).save(2, step.state)
    other = f"{tmp}/ck_{d['other'][role]}"
    deadline = time.time() + 200
    while not os.path.exists(f"{other}/2/state.pt") and time.time() < deadline:
        time.sleep(0.05)
    fresh = stage1()
    CheckpointManager(other).restore(fresh.state, 2)
    out["restored_state"] = fresh.state.state_dict()
    out["stage1_next"] = step(local(d["stage1"][0]))
    out["restored_next"] = fresh(local(d["stage1"][0]))
    model = taste()
    mask = optim.lora_only_mask(model)
    opt = optim.make_optimizer(model, 1e-3, mask=mask, grad_clip=1.0)
    step = train_step.make_stage2_step(model, opt, use_ref_kl=True,
                                       trainable_mask=mask)
    out["stage2"] = [step(local(b), draws={"eps": local({"e": e})["e"]})
                     for b, e in zip(d["stage2"], d["eps"])]
    out["stage2_params"] = {n: p.detach() for n, p in model.named_parameters()
                            if mask[n]}
    flow = MaskedDiffWithXvec(cfg.flow)
    pre = "voice_generator.flow."
    flow.load_state_dict({k[len(pre):]: v for k, v in d["taste_float"].items()
                          if k.startswith(pre)}, strict=True)
    opt = optim.make_optimizer(flow.train(), 1e-3, grad_clip=1.0)
    step = train_step.make_flow_step(flow, opt)
    out["flow"] = [step(local(b)) for b in d["flow"]]
    out["flow_params"] = {n: p.detach() for n, p in flow.named_parameters()}
torch.save(out, f"{tmp}/{role}_{rank}.pt")
mesh.barrier()
dist.destroy_process_group()
print("worker ok", flush=True)
"""


# ---------------------------------------------------------------------------
# the inputs, and the subprocesses started with the module
# ---------------------------------------------------------------------------


def _float_variables():
    return jax.tree.map(np.asarray, tiny_pair()[2])


def _llama_tree(layout: str):
    """The tiny Llama's flax params in a layout (numpy leaves)."""
    tree = _float_variables()["params"]["spoken_lm"]["language_model"]
    if layout == "float":
        return tree
    lora = tiny_pair()[0].spoken_lm.lora
    tree = jq.merge_lora_params(tree, lora.alpha, lora.r)
    return jax.tree.map(np.asarray, jq.quantize_llama_params(
        tree, include_embed=True, mode="int8", embed_head_mode="int8"))


def _llama_inputs():
    r = np.random.RandomState(20)
    return (r.randint(0, 512, (2, 6)).astype(np.int32),
            np.array([6, 4], np.int32), r.randint(0, 512, (2, 2)).astype(np.int32))


def _stage1_batches():
    cfg = TasteConfig.tiny()
    out = []
    for seed in (0, 1):
        b = tiny_batch(cfg, b=4)
        r = np.random.RandomState(10 + seed)
        b["speech_token_ids"] = r.randint(
            0, cfg.speech_decoder.speech_token_size, (4, 12))
        b["speech_token_lengths"] = np.array([12, 9, 12, 7])
        out.append({k: torch.from_numpy(np.asarray(v)).to(
            torch.float32 if np.asarray(v).dtype.kind == "f" else torch.long)
            for k, v in b.items()})
    return out


def _stage2_batches():
    """Global batches of four rows: two lm_inputs prompts each."""
    cfg = TasteConfig.tiny()
    out = []
    for seeds in ((1, 2), (3, 4)):
        parts = [lm_inputs(cfg, s) for s in seeds]
        out.append({k: np.concatenate([p[k] for p in parts]) for k in parts[0]})
    return out


def _stage2_eps(batches):
    """JAX's continue-latent eps of each step on the (2, 2) mesh: the
    state's key split once a step (make_stage2_step)."""
    cfg = TasteConfig.tiny()
    rng, eps = jax.random.PRNGKey(0), []
    for b in batches:
        rng, sub = jax.random.split(rng)
        total = b["llm_token_ids"].shape[1] + cfg.spoken_lm.delay + 1
        eps.append(np.asarray(jax.random.normal(
            sub, (4, total, cfg.audio_tower.quantizer.codebook_dim))))
    return eps


def _flow_batches():
    fc = TasteConfig.tiny().flow
    r = np.random.RandomState(4)
    return [{"speech_token_ids": torch.from_numpy(
                r.randint(0, fc.vocab_size, (4, 12))).long(),
             "speech_token_lengths": torch.tensor([12, 10, 12, 7]),
             "feat": torch.from_numpy(r.randn(4, 16, fc.output_size)).float(),
             "feat_lengths": torch.tensor([16, 14, 16, 11]),
             "embedding": torch.from_numpy(r.randn(4, fc.spk_embed_dim)).float()}
            for _ in range(2)]


def _tables():
    v = TasteConfig.tiny().spoken_lm.llama.vocab_size
    return build_sampler_tables(VocabScan(), v)


def _torch_prompt(seed):
    return {k: torch.from_numpy(v).long()
            for k, v in lm_inputs(TasteConfig.tiny(), seed).items()}


class Runs:
    def __init__(self, tmp):
        self.tmp = tmp
        variables = _float_variables()
        float_sd = convert.to_torch(convert.params_to_state_dict(variables))
        cfg = TasteConfig.tiny()
        ids, lens, nxt = _llama_inputs()
        r = np.random.RandomState(3)
        v = cfg.spoken_lm.llama.vocab_size
        stage2 = _stage2_batches()
        self.stage2_eps = _stage2_eps(stage2)
        inputs = {
            "llama_float": convert.to_torch(convert.llama_state(
                _llama_tree("float"), "")),
            "llama_int8": convert.to_torch(convert.llama_state(
                _llama_tree("int8"), "")),
            "ids": t(ids).long(), "lens": t(lens).long(), "nxt": t(nxt).long(),
            "w_hidden": torch.from_numpy(r.randn(2, 6, 64).astype(np.float32)),
            "w_logits": torch.from_numpy(r.randn(2, 6, v).astype(np.float32)),
            "taste_float": float_sd,
            "taste_int8s": quant.serving_state_dict(
                float_sd, quant.serving_config(cfg, "int8"), "int8"),
            "sampler": SAMPLER, "max_steps": MAX_STEPS,
            "tables": {k: torch.from_numpy(x) for k, x in _tables().items()},
            "prompts": {s: _torch_prompt(s) for s in PROMPTS},
            "stage1": _stage1_batches(),
            "stage2": [{k: torch.from_numpy(x).long() for k, x in b.items()}
                       for b in stage2],
            "eps": [torch.tensor(e) for e in self.stage2_eps],
            "flow": _flow_batches(),
            "other": {"2x2": "2x1", "2x1": "2x2"},
        }
        self.inputs = inputs
        torch.save(inputs, tmp / "inputs.pt")
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        env.pop("WORLD_SIZE", None)
        self.procs, self.logs = {}, {}
        for role, n in (("tp", 2), ("2x2", 4), ("2x1", 2)):
            port = str(_free_port())
            for rank in range(n):
                self._start(f"{role}_{rank}", [
                    sys.executable, "-c", WORKER, role, str(rank), str(n),
                    port, str(tmp)], env)
        self._start("dryrun", [
            sys.executable, "-c", "from taste_spokenlm_tpu_torch.entry import "
            "dryrun_multichip; dryrun_multichip(4, device='cpu')"], env)

    def _start(self, name, cmd, env):
        log = open(self.tmp / f"{name}.log", "w")
        self.logs[name] = self.tmp / f"{name}.log"
        self.procs[name] = subprocess.Popen(cmd, cwd=REPO, env=env,
                                            stdout=log,
                                            stderr=subprocess.STDOUT)

    def wait(self, *names):
        for name in names:
            try:
                rc = self.procs[name].wait(timeout=TIMEOUT)
            except subprocess.TimeoutExpired:
                self.procs[name].kill()
                raise AssertionError(f"{name} ran past {TIMEOUT} s")
            assert rc == 0, self.logs[name].read_text()[-3000:]

    def result(self, role, rank):
        self.wait(f"{role}_{rank}")
        return torch.load(self.tmp / f"{role}_{rank}.pt", weights_only=False)

    def close(self):
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    r = Runs(tmp_path_factory.mktemp("model_axis"))
    yield r
    r.close()


# ---------------------------------------------------------------------------
# the rule table
# ---------------------------------------------------------------------------


def _layout_variables(layout: str):
    variables = _float_variables()
    cfg = tiny_pair()[0]
    if layout == "float":
        return variables
    if layout == "int8_unfused":
        params = dict(variables["params"])
        slm = dict(params["spoken_lm"])
        slm["language_model"] = _llama_tree("int8")
        params["spoken_lm"] = slm
        return dict(variables, params=params)
    mode = layout.split("_")[0]
    return quantize_variables_jax(serving_config(cfg, mode), variables, mode)


def _marker(leaf, axis):
    """leaf's shape and dtype, varying along `axis` only."""
    n = leaf.shape[axis]
    shape = [1] * leaf.ndim
    shape[axis] = n
    idx = (np.arange(n) % 100 + 1).reshape(shape)
    return np.broadcast_to(idx, leaf.shape).astype(leaf.dtype).copy()


@pytest.mark.parametrize("layout", ["float", "int8_unfused", "int8_serving",
                                    "int4_serving"])
def test_param_spec_is_jax_tp_rules(layout):
    """Every parameter of the tiny TasteForCausalLM: the port's param_spec of
    its torch name and shape names the axis JAX's param_spec(path, shape,
    make_mesh(data=4, model=2)) splits, found by giving that leaf values
    that vary along its split axis only and reading which torch tensor, and
    which of its axes, varies after convert.params_to_state_dict."""
    variables = _layout_variables(layout)
    jmesh = jax_mesh.make_mesh(data=4, model=2)
    base = convert.params_to_state_dict(variables)
    want = {}
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    for path, leaf in flat:
        keys = [getattr(p, "key", str(getattr(p, "idx", p))) for p in path]
        spec = jax_mesh.param_spec("/".join(keys), leaf.shape, jmesh)
        axes = [i for i, s in enumerate(spec) if s == "model"]
        if not axes:
            continue
        marked = jax.tree.map(lambda x: x, variables)
        node = marked["params"]
        for k in keys[:-1]:
            node = node[k]
        node[keys[-1]] = _marker(np.asarray(leaf), axes[0])
        got = convert.params_to_state_dict(marked)
        changed = [k for k in got if not np.array_equal(got[k], base[k])]
        assert len(changed) == 1, ("/".join(keys), changed)
        arr = np.asarray(got[changed[0]])
        varies = [a for a in range(arr.ndim)
                  if not np.all(arr == np.take(arr, [0], axis=a))]
        assert len(varies) == 1, (changed, varies)
        want[changed[0]] = varies[0]
    got = {k: mesh.param_spec(k, v.shape, 2) for k, v in base.items()}
    assert {k: a for k, a in got.items() if a is not None} == want
    assert want and any("q_proj" in k or "qkv_proj" in k for k in want)
    assert all(mesh.param_spec(k, v.shape, 1) is None for k, v in base.items())


@pytest.mark.parametrize("layout", ["float", "int8_serving", "int4_serving"])
def test_shard_state_dict_round_trip(layout):
    """The ranks' shards concatenated in rank order along their axis are
    the input, and each loads strictly into the model built with its
    rank's ModelAxis."""
    cfg = TasteConfig.tiny()
    sd = convert.to_torch(convert.params_to_state_dict(
        _layout_variables(layout)))
    if layout != "float":
        cfg = quant.serving_config(cfg, layout.split("_")[0])
    shards = [quant.shard_state_dict(sd, r, 2) for r in range(2)]
    split = 0
    for k, v in sd.items():
        axis = mesh.tp_axis(k, v.shape, 2)
        if axis is None:
            assert all(s[k] is v for s in shards), k
            continue
        split += 1
        assert shards[0][k].shape[axis] == v.shape[axis] // 2
        assert torch.equal(torch.cat([s[k] for s in shards], axis), v), k
    assert split > 0
    for r, shard in enumerate(shards):
        TasteForCausalLM(cfg, device="cpu", model_axis=mesh.ModelAxis(r, 2)
                         ).load_state_dict(shard, strict=True)


def test_init_distributed_takes_the_backend_it_is_given():
    """nccl without a card raises before any process group exists."""
    with pytest.raises(ValueError, match="nccl"):
        mesh.init_distributed(f"localhost:{_free_port()}", 2, 0,
                              torch.device("cpu"), "nccl")
    with pytest.raises(ValueError, match="backend"):
        mesh.init_distributed(f"localhost:{_free_port()}", 2, 0,
                              torch.device("cpu"), "mpi")
    assert not torch.distributed.is_initialized()


# ---------------------------------------------------------------------------
# serving over two ranks
# ---------------------------------------------------------------------------


def _jax_llama_run(layout: str, sharded: bool):
    cfg = tiny_pair()[0]
    lcfg, lora = cfg.spoken_lm.llama, cfg.spoken_lm.lora
    if layout == "int8":
        lcfg, lora = lcfg.replace(quantized_serving="int8",
                                  quantized_embed_serving=True), None
    jlm = JaxLlama(lcfg, lora)
    params = jax.tree.map(jnp.asarray, _llama_tree(layout))
    ids, lens, nxt = _llama_inputs()

    def run(m, ids, lens, nxt):
        full = m(input_ids=ids, attention_lengths=lens)["last_hidden"]
        caches = m.init_cache(2, 9)
        kv = jnp.arange(9)[None, :] < lens[:, None]
        out = m(input_ids=ids, caches=caches, cache_index=jnp.int32(0),
                key_valid=kv)
        steps = [out["last_hidden"]]
        for s in range(2):
            kv = kv | (jnp.arange(9) == 6 + s)[None, :]
            out = m(input_ids=nxt[:, s:s + 1], caches=out["caches"],
                    cache_index=jnp.int32(6 + s), position_offset=lens + s,
                    key_valid=kv)
            steps.append(out["last_hidden"])
        return full, steps, m.logits(steps[-1])
    fn = jax.jit(lambda p, *a: jlm.apply({"params": p}, *a, method=run))
    if not sharded:
        return jax.tree.map(np.asarray, fn(params, ids, lens, nxt)), jlm, params
    jmesh = jax_mesh.make_mesh(data=4, model=2)
    shardings = jax_mesh.param_shardings(jmesh, params)
    assert any("model" in str(s.spec) for s in jax.tree.leaves(shardings))
    with jmesh:
        out = fn(jax.device_put(params, shardings), ids, lens, nxt)
    return jax.tree.map(np.asarray, out), jlm, params


@pytest.mark.parametrize("layout", ["float", "int8"])
def test_llama_over_two_ranks_matches_jax_sharded(runs, layout):
    """The prefill over ragged lengths, two cached steps and the tied head
    on two ranks against JAX's forward with the TP shardings; the two ranks
    agree bit for bit; one embedding, two per layer and one head gather of
    collectives a pass."""
    (full_j, steps_j, logits_j), _, _ = _jax_llama_run(layout, True)
    res = [runs.result("tp", r)[layout] for r in range(2)]
    for a, b in zip([res[0]["full"], *res[0]["steps"], res[0]["logits"]],
                    [res[1]["full"], *res[1]["steps"], res[1]["logits"]]):
        assert torch.equal(a, b)
    got = res[0]
    lens = _llama_inputs()[1]
    for row, n in enumerate(lens):      # padded query rows are junk
        assert np.max(np.abs(got["full"][row, :n].numpy()
                             - full_j[row, :n])) <= FWD_TOL
        assert np.max(np.abs(got["steps"][0][row, :n].numpy()
                             - steps_j[0][row, :n])) <= FWD_TOL
    for g, ref in zip(got["steps"][1:], steps_j[1:]):
        assert np.max(np.abs(g.numpy() - ref)) <= FWD_TOL
    assert rel_err(got["logits"].numpy(), logits_j) <= FWD_TOL
    layers = tiny_pair()[0].spoken_lm.llama.num_hidden_layers
    passes = 4                       # the prefill, the cached prefill, 2 steps
    assert got["collectives"] == {"all_reduce": passes * (1 + 2 * layers),
                                  "all_gather": 1}


def test_llama_gradients_over_two_ranks_match_jax(runs):
    """The float Llama with LoRA over two ranks: the gradient of one scalar
    of its hidden states and logits, per parameter against jax.grad of the
    same scalar (split parameters: the ranks' slices concatenated;
    replicated ones, LoRA's adapters and the norms, whole and alike on both
    ranks), within 2e-5 of each tensor's largest gradient."""
    cfg = tiny_pair()[0]
    jlm = JaxLlama(cfg.spoken_lm.llama, cfg.spoken_lm.lora)
    params = jax.tree.map(jnp.asarray, _llama_tree("float"))
    ids, lens, _ = _llama_inputs()
    w_h = runs.inputs["w_hidden"].numpy()
    w_l = runs.inputs["w_logits"].numpy()

    def loss(p):
        def fwd(m):
            hid = m(input_ids=ids, attention_lengths=lens)["last_hidden"]
            return (hid * w_h).sum() + (m.logits(hid) * w_l).sum()
        return jlm.apply({"params": p}, method=fwd)
    ref = convert.llama_state(jax.tree.map(np.asarray,
                                           jax.jit(jax.grad(loss))(params)), "")
    grads = [runs.result("tp", r)["grads"] for r in range(2)]
    assert set(grads[0]) == set(ref)
    for name, g in ref.items():
        axis = mesh.tp_axis(name, g.shape, 2)
        if axis is None:
            assert torch.equal(grads[0][name], grads[1][name]), name
            got = grads[0][name].numpy()
        else:
            got = torch.cat([grads[r][name] for r in range(2)], axis).numpy()
        assert rel_err(got, g) <= FWD_TOL, name


def _jax_generate(variables, seed, sharded):
    cfg = tiny_pair()[0]
    model = JaxTaste(cfg)
    lm = lm_inputs(cfg, seed)
    tables = {k: jnp.asarray(x) for k, x in _tables().items()}
    fn = jax.jit(lambda var, *a: model.apply(
        var, jax.random.PRNGKey(0), JaxSamplerConfig(**SAMPLER), tables, *a,
        "audio", MAX_STEPS, method=JaxTaste.generate_completion))
    args = [jnp.asarray(lm[k]) for k in ("llm_indices", "llm_token_ids",
                                         "llm_token_lengths", "llm_word_ids")]
    if not sharded:
        return jax.tree.map(np.asarray, fn(variables, *args))
    jmesh = jax_mesh.make_mesh(data=4, model=2)
    with jmesh:
        out = fn(jax.device_put(variables,
                                jax_mesh.param_shardings(jmesh, variables)),
                 *args)
    return jax.tree.map(np.asarray, out)


TRAJECTORY = ("llm_token_ids", "taste_indices", "num_tokens",
              "num_taste_words")


def _outputs_equal(a, b) -> bool:
    """Two ranks' output dicts, tensor for tensor and number for number."""
    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k]
        for k in a)


def _same(got, ref) -> bool:
    return all(np.array_equal(np.asarray(got[k]), np.asarray(ref[k]))
               for k in TRAJECTORY)


def test_generate_completion_over_two_ranks_matches_jax_tp(runs):
    """The float model's greedy joint decode on two ranks: its trajectory
    (text ids, taste indices, token and word counts) equals JAX's under
    make_mesh(data=4, model=2), on the prompt or, as JAX's own TP test
    allows for a reduction-order tie, on the second; the ranks' outputs
    are equal."""
    variables = tiny_pair()[2]
    res = [runs.result("tp", r) for r in range(2)]
    for seed in PROMPTS:
        a, b = res[0][f"gen_float_{seed}"], res[1][f"gen_float_{seed}"]
        assert _outputs_equal(a, b)
    for seed in PROMPTS:
        ref = _jax_generate(variables, seed, True)
        got = {k: res[0][f"gen_float_{seed}"][k].numpy() for k in TRAJECTORY}
        if _same(got, ref):
            break
    for k in TRAJECTORY:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert (got["num_taste_words"] >= 2).all()


def test_int8_serving_generate_over_two_ranks_matches_one_rank(runs):
    """The int8 serving layout (fused qkv held whole and sliced per rank,
    the fused MLP on each rank's block of the intermediate axis, the int8
    embedding split, the int4 head whole): two ranks' trajectories equal
    the port's one-process run on the prompt or on the second."""
    cfg = quant.serving_config(TasteConfig.tiny(), "int8")
    one = TasteForCausalLM(cfg, device="cpu").eval()
    one.load_state_dict(runs.inputs["taste_int8s"], strict=True)
    res = [runs.result("tp", r) for r in range(2)]
    for seed in PROMPTS:
        a, b = res[0][f"gen_int8s_{seed}"], res[1][f"gen_int8s_{seed}"]
        assert _outputs_equal(a, b)
    for seed in PROMPTS:
        lm = runs.inputs["prompts"][seed]
        ref = one.generate_completion(
            SamplerConfig(**SAMPLER), runs.inputs["tables"],
            lm["llm_indices"], lm["llm_token_ids"], lm["llm_token_lengths"],
            lm["llm_word_ids"], max_steps=MAX_STEPS)
        got = res[0][f"gen_int8s_{seed}"]
        if _same(got, ref):
            break
    for k in TRAJECTORY:
        assert torch.equal(got[k], ref[k]), k
    assert (got["num_tokens"] >= 2).all()


def test_gather_built_from_all_reduce_is_all_gathers(runs):
    """The gather that gloo's CUDA tensors take (each rank's part in its row
    of a zeroed buffer, summed) equals dist.all_gather for float, bool and
    integer tensors; a bf16 sum over gloo is the f32 sum rounded once."""
    for r in range(2):
        res = runs.result("tp", r)
        want, got = res["gather"]
        for w, g in zip(want, got):
            assert len(w) == len(g) == 2
            assert all(a.dtype == b.dtype and torch.equal(a, b)
                       for a, b in zip(w, g))
        assert res["bf16_sum"].dtype == torch.bfloat16
        assert torch.equal(res["bf16_sum"], torch.full((1, 4), 4.0,
                                                       dtype=torch.bfloat16))


# ---------------------------------------------------------------------------
# training on the (data, model) mesh
# ---------------------------------------------------------------------------


def _err(got, ref) -> float:
    got, ref = torch.as_tensor(got).double(), torch.as_tensor(ref).double()
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


def test_mesh_places_ranks_row_major(runs):
    """rank = d * model + m, as JAX reshapes its devices."""
    for r in range(4):
        assert runs.result("2x2", r)["place"] == divmod(r, 2)
    assert [runs.result("2x1", r)["place"] for r in range(2)] == [(0, 0),
                                                                  (1, 0)]


@pytest.mark.parametrize("phase", ["stage1", "stage2", "flow"])
def test_data_by_model_matches_data_only(runs, phase):
    """Four ranks at data 2 x model 2 against two at data 2: the same
    metrics and updated parameters within 1e-5; the two ranks of each model
    group, and every rank's parameters, bit for bit."""
    quad = [runs.result("2x2", r) for r in range(4)]
    pair = [runs.result("2x1", r) for r in range(2)]
    for r in range(1, 4):
        for a, b in zip(quad[r][phase], quad[0][phase]):
            assert all(torch.equal(a[k], b[k]) for k in a), (r, a, b)
    for got, ref in zip(quad[0][phase], pair[0][phase]):
        assert set(got) == set(ref)
        for k in ref:
            assert _err(got[k], ref[k]) <= DP_TOL, (phase, k)
    key = {"stage1": "stage1_state", "stage2": "stage2_params",
           "flow": "flow_params"}[phase]

    def tensors(res):
        v = res[key]
        return v["model"] if phase == "stage1" else v
    for r in range(1, 4):
        assert all(torch.equal(a, b) for a, b in zip(
            tensors(quad[r]).values(), tensors(quad[0]).values())), r
    ref = tensors(pair[0])
    for name, v in tensors(quad[0]).items():
        if v.is_floating_point():
            assert _err(v, ref[name]) <= DP_TOL, name
        else:
            assert torch.equal(v, ref[name]), name


def test_checkpoint_restores_across_meshes(runs):
    """The stage-1 state saved at data 2 x model 2 restores at data 2 x
    model 1 and the other way round: the restored parameters, moments,
    step and generator equal the restoring run's own, and the next step
    from each gives the same metrics."""
    for role, n in (("2x2", 4), ("2x1", 2)):
        for r in range(n):
            res = runs.result(role, r)
            own, back = res["stage1_state"], res["restored_state"]
            assert back["step"] == own["step"] == 2
            assert torch.equal(back["generator"], own["generator"])
            for k, v in own["model"].items():
                assert torch.equal(back["model"][k], v), (role, k)
            for k in ("mu", "nu"):
                assert all(torch.equal(a, b) for a, b in
                           zip(back["optimizer"][k], own["optimizer"][k]))
            a, b = res["stage1_next"], res["restored_next"]
            assert all(torch.equal(a[k], b[k]) for k in a), (role, a, b)


def test_stage2_loss_matches_jax_on_the_mesh(runs):
    """The first stage-2 step (LoRA-only mask, use_ref_kl) of the four ranks
    against JAX's make_stage2_step on make_mesh(data=2, model=2) from the
    same parameters and the same global batch and eps: every metric within
    1e-4 relative."""
    cfg, model, variables, _ = tiny_pair()
    params = variables["params"]
    mask = jax_optim.lora_only_mask(params)
    tx = jax_optim.make_optimizer(1e-3, mask=mask, grad_clip=1.0)
    state = jax_train_step.init_state(jax.random.PRNGKey(0), params,
                                      variables["quantizer"], tx)
    jmesh = jax_mesh.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    state = jax.device_put(state, jax_train_step.state_shardings(jmesh, state))
    batch = {k: jnp.asarray(v) for k, v in _stage2_batches()[0].items()}
    batch = jax.device_put(batch, jax_mesh.batch_specs(jmesh, batch))
    step = jax_train_step.make_stage2_step(model, tx, mesh=jmesh,
                                           use_ref_kl=True, donate=False,
                                           trainable_mask=mask)
    with jmesh:
        _, ref = step(state, batch)
    got = runs.result("2x2", 0)["stage2"][0]
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert abs(float(got[k]) - float(v)) <= LOSS_TOL * max(
            abs(float(v)), 1e-6), (k, float(got[k]), float(v))


def test_dryrun_multichip_prints_finite_losses(runs):
    """dryrun_multichip(4, device="cpu"): the (2, 2) mesh and JAX's three
    lines with finite losses."""
    runs.wait("dryrun")
    lines = [x for x in runs.logs["dryrun"].read_text().splitlines()
             if x.startswith("dryrun_multichip")]
    assert len(lines) == 3, lines
    assert "mesh={'data': 2, 'model': 2}" in lines[0]
    values = [float(v) for line in lines for v in
              re.findall(r"=(-?[0-9.]+(?:e-?\d+)?)", line)]
    assert len(values) == 7 and all(np.isfinite(values)), lines
