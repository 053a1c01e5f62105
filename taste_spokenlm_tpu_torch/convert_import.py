"""Reference-named checkpoints <-> the port's state dict: the import
direction of the JAX package's utils/convert.py (which builds flax trees
from them) and the export direction of its utils/export.py.

The port keeps the reference names, so the import is mostly renames:

    HF whisper        {model.}encoder.* / decoder.*  -> audio_tower.audio_joint_
                      encoder_segmenter.{audio_encoder.encoder,
                      audio_segmenter.decoder}.*
    HF Llama          model.* (+ lm_head.weight when untied), or PEFT's
                      base_model.model.model.* with `base_layer.weight`,
                      `lora_A.default.weight`, `lora_B.default.weight`
                      -> spoken_lm.language_model.* (`weight`, `lora_A`,
                      `lora_B`); rotary buffers dropped
    taste composite   audio_tower.* (the RVQ's codebooks to [1, K, D] with
                      embed_avg / cluster_size / initted filled as JAX's
                      importer fills them), speech_decoder.*, spoken_lm.*
                      (its language_model as above); flow.* / hift.* as
                      below, where it holds them
    CosyVoice flow.pt -> voice_generator.flow.*
    CosyVoice hift.pt -> voice_generator.hift.*, each weight-norm pair
                      (weight_g, weight_v) collapsed to `weight`
                      (convert.collapse_weight_norm)

Tensors keep their dtypes (a bf16 file stays bf16).  Weights are read
from `pytorch_model.bin` by torch.load(weights_only=True) and from
`model.safetensors` by `read_safetensors`, a reader of the format's own
header: neither `safetensors` nor `transformers` is needed.

`export_state` is the inverse: the port's state dict (float, or a serving
layout, dequantized first) -> one reference-named composite: the Llama
under PEFT names when it has LoRA adapters, flow.* / hift.* with HiFT's
convs as weight-norm pairs that collapse back to the same weights.
`split_composite` cuts such a composite into the files the importer takes
(an HF whisper state dict, the Llama's, the taste composite's rest,
flow.pt's and hift.pt's).
"""

from __future__ import annotations

import json
import os
import re
import struct
from typing import Dict, Mapping, Optional

import torch

from taste_spokenlm_tpu_torch import convert

TOWER = "audio_tower.audio_joint_encoder_segmenter."
WHISPER_PARTS = {"encoder.": f"{TOWER}audio_encoder.encoder.",
                 "decoder.": f"{TOWER}audio_segmenter.decoder."}
LM = "spoken_lm.language_model."
PEFT_BACKBONE = "base_model.model.model."
PEFT_HEAD = "base_model.model.lm_head.weight"
RVQ = "audio_tower.vq.rvq."
FLOW, HIFT = "voice_generator.flow.", "voice_generator.hift."
# HiFT's weight-normed convs (the rest of its weights are plain)
_WEIGHT_NORMED = re.compile(
    r"(conv_pre|conv_post|ups\.\d+|source_downs\.\d+|"
    r"(source_)?resblocks\.\d+\.convs[12]\.\d+|f0_predictor\.condnet\.\d+)"
    r"\.weight$")

# the leaves of a quantized serving layout (quant.py)
_QUANTIZED = ("base_q", "base_q4", "kernel_q", "kernel_q4", "embedding_q")

State = Dict[str, torch.Tensor]

# ---------------------------------------------------------------------------
# reading and writing weights
# ---------------------------------------------------------------------------

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32,
              "F16": torch.float16, "BF16": torch.bfloat16,
              "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
              "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> State:
    """A .safetensors file -> {name: tensor}: an 8-byte little-endian
    header length, a JSON header {name: {dtype, shape, data_offsets}} (and
    __metadata__), then the raw little-endian data."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = bytearray(f.read())
    out: State = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _ST_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {info['dtype']}, "
                             "which this reader does not take")
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if end == start:
            out[name] = torch.zeros(shape, dtype=dtype)
            continue
        t = torch.frombuffer(data, dtype=dtype, count=(end - start)
                             // torch.empty((), dtype=dtype).element_size(),
                             offset=start)
        out[name] = t.reshape(shape)
    return out


def write_safetensors(state: Mapping[str, torch.Tensor], path: str,
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """{name: tensor} -> a .safetensors file (the header padded with spaces
    to 8 bytes, the tensors in name order)."""
    header: Dict = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    blobs, offset = [], 0
    for name in sorted(state):
        t = state[name].detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy().tobytes() \
            if t.numel() else b""
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)


WEIGHT_FILES = ("model.safetensors", "pytorch_model.bin")


def load_weights(path: str) -> State:
    """A weights file (.safetensors, else torch.load with weights_only), or
    a directory holding model.safetensors / pytorch_model.bin or their
    sharded form (*.index.json with a weight_map)."""
    if os.path.isdir(path):
        for name in WEIGHT_FILES:
            if os.path.exists(os.path.join(path, name)):
                return load_weights(os.path.join(path, name))
            index = os.path.join(path, f"{name}.index.json")
            if os.path.exists(index):
                with open(index) as f:
                    shards = sorted(set(json.load(f)["weight_map"].values()))
                out: State = {}
                for shard in shards:
                    out.update(load_weights(os.path.join(path, shard)))
                return out
        raise FileNotFoundError(f"{path}: no {' or '.join(WEIGHT_FILES)}")
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    return torch.load(path, map_location="cpu", weights_only=True)


# ---------------------------------------------------------------------------
# import: reference names -> the port's
# ---------------------------------------------------------------------------


def _strip(sd: Mapping[str, torch.Tensor], prefix: str) -> State:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def whisper_state(sd: Mapping[str, torch.Tensor]) -> State:
    """An HF whisper checkpoint (WhisperModel or
    WhisperForConditionalGeneration: `model.` prefixed, its tied
    `proj_out` dropped) -> the tower's encoder and decoder."""
    if any(k.startswith("model.") for k in sd):
        sd = _strip(sd, "model.")
    out: State = {}
    for part, dst in WHISPER_PARTS.items():
        out.update({dst + k: v for k, v in _strip(sd, part).items()})
    return out


def _llama_key(key: str) -> Optional[str]:
    """One HF / PEFT Llama backbone key (below the backbone prefix) -> the
    port's; None for rotary buffers."""
    if key.startswith("rotary_emb.") or key.endswith(".rotary_emb.inv_freq"):
        return None
    for peft, ours in ((".base_layer.weight", ".weight"),
                       (".lora_A.default.weight", ".lora_A"),
                       (".lora_B.default.weight", ".lora_B")):
        if key.endswith(peft):
            return key[: -len(peft)] + ours
    return key


def llama_state(sd: Mapping[str, torch.Tensor], prefix: str = LM) -> State:
    """An HF LlamaForCausalLM checkpoint (model.*, lm_head.weight when
    untied) or its PEFT-wrapped form (base_model.model.model.*,
    base_model.model.lm_head.weight) -> the port's names under `prefix`."""
    peft = any(k.startswith(PEFT_BACKBONE) for k in sd)
    backbone, head = ((PEFT_BACKBONE, PEFT_HEAD) if peft
                      else ("model.", "lm_head.weight"))
    out: State = {}
    for k, v in _strip(sd, backbone).items():
        name = _llama_key(k)
        if name is not None:
            out[prefix + name] = v
    if head in sd:
        out[f"{prefix}lm_head.weight"] = sd[head]
    return out


def rvq_state(sd: Mapping[str, torch.Tensor], prefix: str = RVQ) -> State:
    """A vector-quantize-pytorch ResidualVQ under `prefix` -> the port's:
    codebooks [1, K, D], embed_avg (the codebook where absent),
    cluster_size [1, K] (ones where absent) and initted, as JAX's
    importer fills them."""
    sub = _strip(sd, prefix)
    out: State = {}
    for k, v in sub.items():
        if k.startswith(("project_in.", "project_out.")):
            out[prefix + k] = v
    levels = sorted({int(k.split(".")[1]) for k in sub
                     if k.startswith("layers.") and "._codebook." in k})
    for i in levels:
        base = f"layers.{i}._codebook."
        embed = sub[base + "embed"]
        embed = embed[0] if embed.dim() == 3 else embed
        avg = sub.get(base + "embed_avg", embed)
        avg = avg[0] if avg.dim() == 3 else avg
        cs = sub.get(base + "cluster_size")
        cs = (torch.ones(embed.shape[0], dtype=torch.float32) if cs is None
              else cs.reshape(-1))
        out[f"{prefix}{base}embed"] = embed[None]
        out[f"{prefix}{base}embed_avg"] = avg[None]
        out[f"{prefix}{base}cluster_size"] = cs[None]
        out[f"{prefix}{base}initted"] = torch.ones(1, dtype=torch.float32)
    return out


def taste_state(sd: Mapping[str, torch.Tensor]) -> State:
    """A taste_speech composite checkpoint -> the tower (whisper encoder
    and decoder, the RVQ), the speech decoder and the spoken LM (its Llama
    in plain or PEFT names, the bridges and embeddings); and the voice
    generator where the composite holds flow.* / hift.* (export_state's
    does), which JAX's importer leaves out."""
    out: State = {}
    out.update(flow_state(_strip(sd, "flow.")))
    out.update(hift_state(_strip(sd, "hift.")))
    for k, v in sd.items():
        if k.startswith("audio_tower.") and not k.startswith(RVQ):
            out[k] = v
        elif k.startswith("speech_decoder."):
            out[k] = v
        elif k.startswith("spoken_lm.") and not k.startswith(LM):
            out[k] = v
    out.update(rvq_state(sd))
    out.update(llama_state(_strip(sd, LM)))
    return out


def flow_state(sd: Mapping[str, torch.Tensor]) -> State:
    """CosyVoice flow.pt -> voice_generator.flow.*."""
    return {FLOW + k: v for k, v in sd.items()}


def hift_state(sd: Mapping[str, torch.Tensor]) -> State:
    """CosyVoice hift.pt -> voice_generator.hift.*, each weight-norm pair
    collapsed in f32 and returned at v's dtype."""
    pairs = {k: v.detach().float().numpy() for k, v in sd.items()
             if k.endswith((".weight_g", ".weight_v"))}
    out: State = {HIFT + k: v for k, v in sd.items() if k not in pairs}
    for k, w in convert.collapse_weight_norm(pairs).items():
        dtype = sd[k[: -len(".weight")] + ".weight_v"].dtype
        out[HIFT + k] = torch.from_numpy(w).to(dtype)
    return out


def import_checkpoint(whisper: Optional[Mapping] = None,
                      llama: Optional[Mapping] = None,
                      taste: Optional[Mapping] = None,
                      flow: Optional[Mapping] = None,
                      hift: Optional[Mapping] = None) -> State:
    """The reference checkpoints that are given -> one state dict in the
    port's names, merged in JAX's order (whisper, llama, taste, flow,
    hift), a later source's entry replacing an earlier one's."""
    out: State = {}
    for sd, fn in ((whisper, whisper_state), (llama, llama_state),
                   (taste, taste_state), (flow, flow_state),
                   (hift, hift_state)):
        if sd is not None:
            out.update(fn(sd))
    return out


# ---------------------------------------------------------------------------
# export: the port's names -> reference names
# ---------------------------------------------------------------------------


def export_state(sd: Mapping[str, torch.Tensor], cfg=None) -> State:
    """The port's TasteForCausalLM state dict -> one reference-named
    composite (JAX's export.composite_taste_state names).  A serving
    layout (`cfg` its config) is dequantized first to f32, as JAX's
    exporter does (quant.dequantized_state_dict); a float one keeps its
    dtypes."""
    from taste_spokenlm_tpu_torch import quant
    if any(k.rpartition(".")[2] in _QUANTIZED for k in sd):
        sd = quant.dequantized_state_dict(dict(sd), cfg)
    lm = _strip(sd, LM)
    peft = any(k.endswith((".lora_A", ".lora_B")) for k in lm)
    out: State = {}
    for k, v in sd.items():
        if k.startswith(LM):
            continue
        if k.startswith(FLOW):
            out["flow." + k[len(FLOW):]] = v
        elif k.startswith(HIFT):
            name = k[len(HIFT):]
            if _WEIGHT_NORMED.fullmatch(name):
                base = "hift." + name[: -len(".weight")]
                out[base + ".weight_g"] = torch.from_numpy(
                    convert.weight_norm_g(v.detach().float().numpy()))
                out[base + ".weight_v"] = v
            else:
                out["hift." + name] = v
        else:
            out[k] = v
    lora = {k[: -len(".lora_A")] for k in lm if k.endswith(".lora_A")}
    for k, v in lm.items():
        if k == "lm_head.weight":
            out[LM + (PEFT_HEAD if peft else "lm_head.weight")] = v
            continue
        if not peft:
            out[f"{LM}model.{k}"] = v
        elif k.endswith(".lora_A") or k.endswith(".lora_B"):
            out[f"{LM}{PEFT_BACKBONE}{k[:-7]}.{k[-6:]}.default.weight"] = v
        elif k.endswith(".weight") and k[: -len(".weight")] in lora:
            out[f"{LM}{PEFT_BACKBONE}{k[:-7]}.base_layer.weight"] = v
        else:
            out[f"{LM}{PEFT_BACKBONE}{k}"] = v
    return out


def split_composite(state: Mapping[str, torch.Tensor]) -> Dict[str, State]:
    """A reference-named composite (export_state's) -> the sources of
    `import_checkpoint`: "whisper" (HF WhisperForConditionalGeneration
    names, model.encoder.* / model.decoder.*), "llama" (the backbone's own
    names: model.* or PEFT's base_model.model.*), "taste" (the RVQ, the
    speech decoder, the spoken LM's bridges and embeddings), "flow" and
    "hift" (CosyVoice's file names)."""
    out: Dict[str, State] = {n: {} for n in ("whisper", "llama", "taste",
                                             "flow", "hift")}
    whisper = {dst: "model." + src for src, dst in WHISPER_PARTS.items()}
    for k, v in state.items():
        part = next((p for p in whisper if k.startswith(p)), None)
        if part is not None:
            out["whisper"][whisper[part] + k[len(part):]] = v
        elif k.startswith(LM):
            out["llama"][k[len(LM):]] = v
        elif k.startswith("flow."):
            out["flow"][k[len("flow."):]] = v
        elif k.startswith("hift."):
            out["hift"][k[len("hift."):]] = v
        else:
            out["taste"][k] = v
    return out
