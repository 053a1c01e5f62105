"""JAX parameter tree (as numpy) -> the port's state dict.

The port's own copy of the parts of the JAX package's utils/export.py that
its slices need (audio tower, RVQ, speech decoder, conformer, spoken LM with
its Llama and bridges, flow, CFM estimator, HiFT).  Keys are the reference
state-dict names, so a published TASTE / CosyVoice checkpoint can load the
same way:

    sd = params_to_state_dict(jax.tree.map(np.asarray, variables))
    model.load_state_dict(to_torch(sd), strict=True)

Linear weights come out [out, in], convs channels-first, LayerNorm
{scale, bias} as {weight, bias}.  The int8 / uint8 arrays of the quantized
serving layouts (utils/quant.py's base_q / base_scale, kernel_q / scale,
embedding_q / embedding_scale / head_q4 / head_scale4, fused qkv_proj,
gateup_proj and linear_qkv) go across unchanged, [in, out] as in JAX.  HiFT's weight-norm convs are emitted as
(weight_g, weight_v) pairs, as the reference stores them, and
`collapse_weight_norm` turns each pair into the one `weight` the port's
modules hold.  Layouts a kernel wants (conv1d_same's [K, Cin, Cout], the
fused DiT block's [in, out]) are prepared by the modules when the state
dict is loaded.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np


def _np(x) -> np.ndarray:
    a = np.asarray(x)
    return a.astype(np.float32) if np.issubdtype(a.dtype, np.floating) else a


def _put_dense(out: Dict, base: str, p: Mapping):
    out[f"{base}.weight"] = _np(p["kernel"]).T
    if "bias" in p:
        out[f"{base}.bias"] = _np(p["bias"])


def _put_linear(out: Dict, base: str, p: Mapping):
    """A Dense leaf, float ({kernel, bias?}) or the QDense / QDense4 layout
    ({kernel_q or kernel_q4, scale, bias?}, unchanged)."""
    if "kernel_q" in p or "kernel_q4" in p:
        for k, v in p.items():
            out[f"{base}.{k}"] = _np(v)
    else:
        _put_dense(out, base, p)


def _put_norm(out: Dict, base: str, p: Mapping):
    out[f"{base}.weight"] = _np(p["scale"])
    if "bias" in p:
        out[f"{base}.bias"] = _np(p["bias"])


def _put_conv(out: Dict, base: str, p: Mapping):
    """flax Conv kernel [k, in, out] -> torch Conv1d weight [out, in, k]."""
    out[f"{base}.weight"] = _np(p["kernel"]).transpose(2, 1, 0)
    if "bias" in p:
        out[f"{base}.bias"] = _np(p["bias"])


# ---------------------------------------------------------------------------
# whisper / audio tower / RVQ
# ---------------------------------------------------------------------------


def _whisper_layer(out: Dict, base: str, layer: Mapping):
    for mod, sub in layer.items():
        if mod in ("self_attn", "encoder_attn"):
            for proj, p in sub.items():
                _put_dense(out, f"{base}.{mod}.{proj}", p)
        elif mod in ("fc1", "fc2"):
            _put_dense(out, f"{base}.{mod}", sub)
        elif mod.endswith("layer_norm"):
            _put_norm(out, f"{base}.{mod}", sub)
        else:
            raise KeyError(f"unhandled whisper layer param: {base}.{mod}")


def whisper_encoder_state(tree: Mapping, prefix: str = "") -> Dict:
    out: Dict = {}
    for name, sub in tree.items():
        if name in ("conv1", "conv2"):
            _put_conv(out, f"{prefix}{name}", sub)
        elif name == "embed_positions":
            out[f"{prefix}embed_positions.weight"] = _np(sub)
        elif name == "layer_norm":
            _put_norm(out, f"{prefix}layer_norm", sub)
        elif name.startswith("layers_"):
            _whisper_layer(out, f"{prefix}layers.{name.split('_')[-1]}", sub)
        else:
            raise KeyError(f"unhandled whisper encoder param: {name}")
    return out


def whisper_decoder_state(tree: Mapping, prefix: str = "") -> Dict:
    out: Dict = {}
    for name, sub in tree.items():
        if name in ("embed_tokens", "embed_positions"):
            out[f"{prefix}{name}.weight"] = _np(sub["embedding"])
        elif name == "layer_norm":
            _put_norm(out, f"{prefix}layer_norm", sub)
        elif name.startswith("layers_"):
            _whisper_layer(out, f"{prefix}layers.{name.split('_')[-1]}", sub)
        else:
            raise KeyError(f"unhandled whisper decoder param: {name}")
    return out


def rvq_state_dict(params: Mapping, quantizer: Mapping, prefix: str) -> Dict:
    """(flax RVQ params, "quantizer" collection) -> vector-quantize-pytorch
    ResidualVQ names, with the leading [1, ...] codebook-head dim."""
    out: Dict = {}
    for name in ("project_in", "project_out"):
        if name in params:
            _put_dense(out, f"{prefix}{name}", params[name])
    embed = _np(quantizer["embed"])                        # [L, K, D]
    avg = _np(quantizer.get("embed_avg", embed))
    cs = _np(quantizer.get("cluster_size",
                           np.ones(embed.shape[:2], np.float32)))
    initted = bool(np.asarray(quantizer.get("initted", True)))
    for i in range(embed.shape[0]):
        base = f"{prefix}layers.{i}._codebook"
        out[f"{base}.embed"] = embed[i][None]
        out[f"{base}.embed_avg"] = avg[i][None]
        out[f"{base}.cluster_size"] = cs[i][None]
        out[f"{base}.initted"] = np.asarray([initted], np.float32)
    return out


def audio_tower_state(tree: Mapping, quantizer: Optional[Mapping] = None,
                      prefix: str = "audio_tower.") -> Dict:
    out: Dict = {}
    seg = f"{prefix}audio_joint_encoder_segmenter."
    out.update(whisper_encoder_state(tree["encoder"],
                                     f"{seg}audio_encoder.encoder."))
    out.update(whisper_decoder_state(tree["decoder"],
                                     f"{seg}audio_segmenter.decoder."))
    if "vq" in tree and quantizer is not None:
        out.update(rvq_state_dict(tree["vq"], quantizer, f"{prefix}vq.rvq."))
    return out


# ---------------------------------------------------------------------------
# conformer / speech decoder
# ---------------------------------------------------------------------------


def conformer_state(tree: Mapping, prefix: str) -> Dict:
    """flax ConformerEncoder (linear input layers, no conv module) ->
    CosyVoice encoder names."""
    out: Dict = {}
    for name, sub in tree.items():
        if name == "embed_linear":
            _put_dense(out, f"{prefix}embed.out.0", sub)
        elif name == "embed_norm":
            _put_norm(out, f"{prefix}embed.out.1", sub)
        elif name == "after_norm":
            _put_norm(out, f"{prefix}after_norm", sub)
        elif name.startswith("encoders_"):
            base = f"{prefix}encoders.{name.split('_')[-1]}"
            for mod, msub in sub.items():
                if mod == "self_attn":
                    for p_name, p in msub.items():
                        if p_name in ("pos_bias_u", "pos_bias_v"):
                            out[f"{base}.self_attn.{p_name}"] = _np(p)
                        else:
                            _put_linear(out, f"{base}.self_attn.{p_name}", p)
                elif mod == "feed_forward":
                    for p_name, p in msub.items():
                        _put_linear(out, f"{base}.{mod}.{p_name}", p)
                elif mod in ("norm1", "norm2", "norm_mha", "norm_ff"):
                    _put_norm(out, f"{base}.{mod}", msub)
                else:
                    raise KeyError(f"unhandled conformer layer param: "
                                   f"{base}.{mod}")
        else:
            raise KeyError(f"unhandled conformer param: {name}")
    return out


def speech_decoder_state(tree: Mapping, prefix: str = "speech_decoder.") -> Dict:
    out: Dict = {}
    for name, sub in tree.items():
        if name in ("text_embedding", "llm_embedding", "speech_embedding"):
            out[f"{prefix}{name}.weight"] = _np(sub["embedding"])
        elif name in ("text_encoder_affine_layer",
                      "audio_token_encoder_affine_layer",
                      "audio_embed_affine_layer", "spk_embed_affine_layer",
                      "llm_decoder"):
            _put_linear(out, f"{prefix}{name}", sub)
        elif name == "fuse_weights":
            out[f"{prefix}fuse_encoded_audio_text_module.weights"] = _np(sub)
        elif name in ("text_encoder", "audio_token_encoder", "llm"):
            out.update(conformer_state(sub, f"{prefix}{name}."))
        else:
            raise KeyError(f"unhandled speech decoder param: {name}")
    return out


# ---------------------------------------------------------------------------
# spoken LM: Llama backbone and bridges
# ---------------------------------------------------------------------------


def _put_projection(out: Dict, base: str, p: Mapping):
    """A LoraDense: float {base: {kernel, bias?}, lora_a?, lora_b?}, the int8
    {base_q, base_scale} or the int4 {base_q4, base_scale}."""
    for k, v in p.items():
        if k == "base":
            _put_dense(out, base, v)
        elif k in ("lora_a", "lora_b"):
            out[f"{base}.lora_{k[-1].upper()}"] = _np(v).T
        elif k in ("base_q", "base_q4", "base_scale"):
            out[f"{base}.{k}"] = _np(v)
        else:
            raise KeyError(f"unhandled projection param: {base}.{k}")


def llama_state(tree: Mapping, prefix: str) -> Dict:
    """flax LlamaModel -> HF Llama names (float or quantized serving
    layout)."""
    out: Dict = {}
    for name, sub in tree.items():
        if name == "embed_tokens":
            if "embedding" in sub:
                out[f"{prefix}embed_tokens.weight"] = _np(sub["embedding"])
            else:
                for k, v in sub.items():
                    out[f"{prefix}embed_tokens.{k}"] = _np(v)
        elif name == "norm":
            out[f"{prefix}norm.weight"] = _np(sub["weight"])
        elif name == "lm_head_kernel":
            out[f"{prefix}lm_head.weight"] = _np(sub).T
        elif name.startswith("layers_"):
            base = f"{prefix}layers.{name.split('_')[-1]}"
            for mod, msub in sub.items():
                if mod in ("input_layernorm", "post_attention_layernorm"):
                    out[f"{base}.{mod}.weight"] = _np(msub["weight"])
                elif mod in ("self_attn", "mlp"):
                    for proj, p in msub.items():
                        _put_projection(out, f"{base}.{mod}.{proj}", p)
                else:
                    raise KeyError(f"unhandled llama param: {base}.{mod}")
        else:
            raise KeyError(f"unhandled llama param: {name}")
    return out


def spoken_lm_state(tree: Mapping, prefix: str = "spoken_lm.") -> Dict:
    """flax TasteSpokenLM -> the port's names: language_model.* (Llama),
    the bridges' Linears as {weight, bias} and their bare parameters."""
    out: Dict = {}
    for name, sub in tree.items():
        if name == "language_model":
            out.update(llama_state(sub, f"{prefix}language_model."))
        elif name in ("fuse_for_bridge_in_llm", "extract_for_bridge_out_llm"):
            for p_name, p in sub.items():
                if isinstance(p, Mapping):
                    _put_dense(out, f"{prefix}{name}.{p_name}", p)
                else:
                    out[f"{prefix}{name}.{p_name}"] = _np(p)
        elif name in ("pad_text_unit_embed", "pad_audio_unit_embed"):
            out[f"{prefix}{name}"] = _np(sub)
        else:
            raise KeyError(f"unhandled spoken_lm param: {name}")
    return out


# ---------------------------------------------------------------------------
# flow / CFM estimator
# ---------------------------------------------------------------------------


def _put_groupnorm(out: Dict, base: str, p: Mapping):
    out[f"{base}.weight"] = _np(p["scale"])
    out[f"{base}.bias"] = _np(p["bias"])


def estimator_state(tree: Mapping, prefix: str) -> Dict:
    """flax ConditionalDecoder -> matcha / CosyVoice estimator names."""
    out: Dict = {}

    def has_peer(kind: str, i: int) -> bool:
        return f"{kind}_{i}_resnet" in tree

    for name, sub in tree.items():
        if name in ("time_mlp_1", "time_mlp_2"):
            _put_dense(out, f"{prefix}time_mlp.linear_{name[-1]}", sub)
        elif name.endswith("_resnet"):
            kind, i, _ = name.split("_")
            base = f"{prefix}{kind}_blocks.{i}.0"
            _put_dense(out, f"{base}.mlp.1", sub["mlp"])
            for blk in ("block1", "block2"):
                _put_conv(out, f"{base}.{blk}.block.0", sub[blk]["conv"])
                _put_groupnorm(out, f"{base}.{blk}.block.1", sub[blk]["norm"])
            _put_conv(out, f"{base}.res_conv", sub["res_conv"])
        elif "_tf_" in name:
            kind, i, _, j = name.split("_")
            base = f"{prefix}{kind}_blocks.{i}.1.{j}"
            attn = sub["attn1"]
            for p in ("to_q", "to_k", "to_v"):
                out[f"{base}.attn1.{p}.weight"] = _np(attn[p]["kernel"]).T
            _put_dense(out, f"{base}.attn1.to_out.0", attn["to_out"])
            for norm in ("norm1", "norm3"):
                _put_norm(out, f"{base}.{norm}", sub[norm])
            _put_dense(out, f"{base}.ff.net.0.proj", sub["ff_in"])
            _put_dense(out, f"{base}.ff.net.2", sub["ff_out"])
        elif name.endswith("_downsample"):
            i = int(name.split("_")[1])
            _put_conv(out, f"{prefix}down_blocks.{i}.2"
                      + (".conv" if has_peer("down", i + 1) else ""), sub)
        elif name.endswith("_upsample"):
            i = int(name.split("_")[1])
            if has_peer("up", i + 1):
                # ConvTranspose1d: ours [k, out, in] -> torch [in, out, k]
                out[f"{prefix}up_blocks.{i}.2.conv.weight"] = \
                    _np(sub["kernel"]).transpose(2, 1, 0)
                out[f"{prefix}up_blocks.{i}.2.conv.bias"] = _np(sub["bias"])
            else:
                _put_conv(out, f"{prefix}up_blocks.{i}.2", sub)
        elif name == "final_block":
            _put_conv(out, f"{prefix}final_block.block.0", sub["conv"])
            _put_groupnorm(out, f"{prefix}final_block.block.1", sub["norm"])
        elif name == "final_proj":
            _put_conv(out, f"{prefix}final_proj", sub)
        else:
            raise KeyError(f"unhandled estimator param: {name}")
    return out


def flow_state(tree: Mapping, prefix: str = "flow.") -> Dict:
    """flax MaskedDiffWithXvec -> CosyVoice flow names."""
    out: Dict = {}
    for name, sub in tree.items():
        if name == "input_embedding":
            out[f"{prefix}input_embedding.weight"] = _np(sub["embedding"])
        elif name in ("spk_embed_affine_layer", "encoder_proj"):
            _put_dense(out, f"{prefix}{name}", sub)
        elif name == "encoder":
            out.update(conformer_state(sub, f"{prefix}encoder."))
        elif name == "length_regulator":
            n_convs = sum(1 for k in sub if k.startswith("conv_"))
            for p_name, p in sub.items():
                base = f"{prefix}length_regulator.model"
                if p_name.startswith("conv_"):
                    _put_conv(out, f"{base}.{int(p_name[5:]) * 3}", p)
                elif p_name.startswith("norm_"):
                    _put_groupnorm(out, f"{base}.{int(p_name[5:]) * 3 + 1}", p)
                elif p_name == "proj":
                    _put_conv(out, f"{base}.{n_convs * 3}", p)
                else:
                    raise KeyError(f"unhandled length_regulator param: {p_name}")
        elif name == "decoder":
            out.update(estimator_state(sub["estimator"],
                                       f"{prefix}decoder.estimator."))
        else:
            raise KeyError(f"unhandled flow param: {name}")
    return out


# ---------------------------------------------------------------------------
# HiFT
# ---------------------------------------------------------------------------


def _put_weight_norm_conv(out: Dict, base: str, p: Mapping):
    """A torch weight-norm (weight_g, weight_v) pair whose collapsed weight
    is ours: v = w, g = ||w|| over every dim but 0 (the same transpose
    serves Conv1d [out, in, k] and ConvTranspose1d [in, out, k])."""
    w = _np(p["kernel"]).transpose(2, 1, 0)
    out[f"{base}.weight_g"] = np.sqrt(np.sum(w * w, axis=(1, 2), keepdims=True))
    out[f"{base}.weight_v"] = w
    if "bias" in p:
        out[f"{base}.bias"] = _np(p["bias"])


def _resblock_state(out: Dict, base: str, block: Mapping):
    for name, p in block.items():
        which, i = name.split("_")
        if which in ("conv1", "conv2"):
            _put_weight_norm_conv(out, f"{base}.convs{which[-1]}.{i}", p)
        elif which in ("alpha1", "alpha2"):
            out[f"{base}.activations{which[-1]}.{i}.alpha"] = \
                _np(p).reshape(1, -1, 1)
        else:
            raise KeyError(f"unhandled resblock param: {base}.{name}")


def hift_state(tree: Mapping, prefix: str = "hift.") -> Dict:
    """flax HiFTGenerator -> HiFTNet names, weight-norm convs as
    (weight_g, weight_v) pairs."""
    out: Dict = {}
    resblocks = {}
    for name, sub in tree.items():
        if name in ("conv_pre", "conv_post"):
            _put_weight_norm_conv(out, f"{prefix}{name}", sub)
        elif name.startswith("ups_"):
            _put_weight_norm_conv(out, f"{prefix}ups.{name[4:]}", sub)
        elif name.startswith("source_downs_"):
            _put_weight_norm_conv(out, f"{prefix}source_downs.{name[13:]}", sub)
        elif name.startswith("source_resblocks_"):
            _resblock_state(out, f"{prefix}source_resblocks.{name[17:]}", sub)
        elif name.startswith("resblocks_"):
            up_idx, k_idx = name.split("_")[1:]
            resblocks[(int(up_idx), int(k_idx))] = sub
        elif name == "source_linear":
            _put_dense(out, f"{prefix}m_source.l_linear", sub)
        elif name == "f0_predictor":
            for p_name, p in sub.items():
                if p_name.startswith("cond_"):
                    k = int(p_name.split("_")[-1])
                    _put_weight_norm_conv(
                        out, f"{prefix}f0_predictor.condnet.{k * 2}", p)
                elif p_name == "classifier":
                    _put_dense(out, f"{prefix}f0_predictor.classifier", p)
                else:
                    raise KeyError(f"unhandled f0_predictor param: {p_name}")
        else:
            raise KeyError(f"unhandled hift param: {name}")
    if resblocks:
        num_kernels = max(k for _, k in resblocks) + 1
        for (u, k), sub in resblocks.items():
            _resblock_state(out, f"{prefix}resblocks.{u * num_kernels + k}", sub)
    return out


def collapse_weight_norm(state: Dict) -> Dict:
    """Replace every (X.weight_g, X.weight_v) pair by X.weight =
    g * v / ||v|| (norm over every dim but 0, torch's weight_norm dim=0)."""
    out = {}
    for key, value in state.items():
        if key.endswith(".weight_g"):
            continue
        if key.endswith(".weight_v"):
            base = key[: -len(".weight_v")]
            g = state[f"{base}.weight_g"]
            v = value
            norm = np.sqrt(np.sum(v.astype(np.float64) ** 2,
                                  axis=tuple(range(1, v.ndim)), keepdims=True))
            out[f"{base}.weight"] = (v * (g / norm)).astype(np.float32)
        else:
            out[key] = value
    return out


# ---------------------------------------------------------------------------
# the slice
# ---------------------------------------------------------------------------


def params_to_state_dict(variables: Mapping) -> Dict:
    """JAX TasteForCausalLM variables ({"params", "quantizer"}, numpy
    leaves) -> the state dict of the port's TasteForCausalLM: audio_tower.*,
    speech_decoder.*, spoken_lm.* (when the tree has it) and
    voice_generator.{flow,hift}.*."""
    params = variables["params"]
    quantizer = variables.get("quantizer", {})
    out: Dict = {}
    out.update(audio_tower_state(
        params["audio_tower"], quantizer.get("audio_tower", {}).get("vq")))
    out.update(speech_decoder_state(params["speech_decoder"]))
    if "spoken_lm" in params:
        out.update(spoken_lm_state(params["spoken_lm"]))
    vg = params["voice_generator"]
    out.update(flow_state(vg["flow"], "voice_generator.flow."))
    out.update(hift_state(vg["hift"], "voice_generator.hift."))
    return collapse_weight_norm(out)


def to_torch(state: Dict):
    """numpy state dict -> torch tensors for load_state_dict."""
    import torch
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in state.items()}
