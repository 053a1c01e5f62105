# Frozen copy of taste_spokenlm_tpu_torch/config.py at commit 1a9abc6: the plain path
# that the benchmark holds the port against.  Kernel, remat and
# data-parallel routes resolve to portbench/reference/stubs.py.
"""Single typed configuration tree for the whole framework.

The PyTorch port keeps its own copy of the JAX package's config module, field
for field, so `to_dict()` / `from_dict()` JSON is interchangeable between the
two packages.

Replaces the reference's four coexisting config systems (argparse+YAML,
HyperPyYAML, HF PretrainedConfig JSON, DeepSpeed JSON — see
reference configs/model/taslm.json and
reference taste_speech/configuration_taste.py:6-202) with plain frozen
dataclasses.  `TasteConfig.full()` reproduces the published TASTE-V0
hyperparameters; `TasteConfig.tiny()` is a fast-test configuration with the
same topology at toy sizes.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple


def _asdict(obj) -> Any:
    if dataclasses.is_dataclass(obj):
        return {k: _asdict(v) for k, v in dataclasses.asdict(obj).items()}
    return obj


class _Base:
    def to_dict(self) -> dict:
        return _asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict):
        fields = {f.name: f for f in dataclasses.fields(cls)}
        kwargs = {}
        for k, v in d.items():
            if k not in fields:
                continue
            ftype = fields[k].type
            sub = _CONFIG_TYPES.get(str(ftype).replace("Optional[", "").rstrip("]"))
            if sub is not None and isinstance(v, dict):
                v = sub.from_dict(v)
            kwargs[k] = v
        return cls(**kwargs)

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Audio frontend
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AudioFrontendConfig(_Base):
    """Constants of the audio interface.

    Mirrors reference taste_speech/modules_taste/cosyvoice/whisper_frontend.py:7-113
    (whisper mel) and processing_taste.py:228,295-324 (16 kHz in, fbank-80 speaker
    path, 128-mel S3 path, <=30 s).
    """

    sample_rate: int = 16000
    output_sample_rate: int = 22050
    # whisper log-mel
    n_fft: int = 400
    hop_length: int = 160
    n_mels: int = 128
    max_audio_seconds: float = 30.0
    # kaldi fbank (speaker-embedding path)
    fbank_mels: int = 80
    # S3 speech tokens
    s3_token_rate: int = 50
    s3_vocab_size: int = 4096

    @property
    def n_samples(self) -> int:
        return int(self.sample_rate * self.max_audio_seconds)

    @property
    def n_frames(self) -> int:
        # whisper drops the final STFT frame: 480000/160 = 3000 frames
        return self.n_samples // self.hop_length


# ---------------------------------------------------------------------------
# Whisper-style encoder/decoder (the TASTE tokenizer backbone)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class WhisperConfig(_Base):
    """Whisper architecture hyperparameters.

    Matches HF whisper config semantics (reference taslm.json `asr_config`):
    large-v3 = 32L/1280d/20h, distil-large-v3 = 32L encoder + 2L decoder.
    """

    vocab_size: int = 51866
    d_model: int = 1280
    encoder_layers: int = 32
    encoder_heads: int = 20
    decoder_layers: int = 2
    decoder_heads: int = 20
    ffn_dim: int = 5120
    n_mels: int = 128
    max_source_positions: int = 1500
    max_target_positions: int = 448
    activation: str = "gelu"
    # decoder prompt prepended by the tokenizer tower
    # (reference taste_speech/modeling_taste.py:145-160)
    decoder_prompt: Tuple[int, ...] = (50258, 50259, 50360, 50364)
    eos_token_id: int = 50257
    # ASR decode suppression (HF whisper-large-v3 generation_config:
    # suppress_tokens = the non-speech token list, begin_suppress_tokens =
    # [" ", eos], timestamps suppressed from no_timestamps+1 when decoding
    # with return_timestamps=None — processing_taste.py:256-266)
    suppress_ids: Tuple[int, ...] = (
        1, 2, 7, 8, 9, 10, 14, 25, 26, 27, 28, 29, 31, 58, 59, 60, 61, 62,
        63, 90, 91, 92, 93, 359, 503, 522, 542, 873, 893, 902, 918, 922,
        931, 1350, 1853, 1982, 2460, 2627, 3246, 3253, 3268, 3536, 3846,
        3961, 4183, 4667, 6585, 6647, 7273, 9061, 9383, 10428, 10929, 11938,
        12033, 12331, 12562, 13793, 14157, 14635, 15265, 15618, 16553,
        16604, 18362, 18956, 20075, 21675, 22520, 26130, 26161, 26435,
        28279, 29464, 31650, 32302, 32470, 36865, 42863, 47425, 49870,
        50254, 50258, 50359, 50360, 50361, 50362, 50363)
    begin_suppress_ids: Tuple[int, ...] = (220, 50257)
    timestamp_begin_id: int = 50365  # <|0.00|>; -1 disables
    # per-layer gradient checkpointing on the encoder (training memory):
    # False | True (recompute all) | 'dots' / 'dots_no_batch' (save MXU dot
    # outputs, recompute the elementwise tail — ops/remat.py)
    remat: Any = False

    @classmethod
    def tiny(cls) -> "WhisperConfig":
        return cls(
            vocab_size=1000, d_model=64, encoder_layers=2, encoder_heads=4,
            decoder_layers=2, decoder_heads=4, ffn_dim=128, n_mels=128,
            max_source_positions=96, max_target_positions=64,
            decoder_prompt=(1, 2, 3, 4), eos_token_id=5,
            suppress_ids=(7, 8), begin_suppress_ids=(6,),
            timestamp_begin_id=990,
        )


# ---------------------------------------------------------------------------
# Quantizer
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class QuantizerConfig(_Base):
    """Residual VQ (reference taslm.json kwargs_for_quantizer: 4x512x256 over 1280-d)."""

    dim: int = 1280
    codebook_dim: int = 256
    codebook_size: int = 512
    num_quantizers: int = 4
    decay: float = 0.99
    epsilon: float = 1e-5
    kmeans_init: bool = True
    kmeans_iters: int = 100
    threshold_ema_dead_code: int = 2
    quantize_dropout: bool = True
    quantize_dropout_cutoff_index: int = 1
    commitment_weight: float = 1.0
    # stochastic (gumbel) code sampling during training
    # (vector_quantize_pytorch.py:86-105; eval stays greedy argmin)
    stochastic_sample_codes: bool = False
    sample_codebook_temp: float = 1.0
    # feature-dim groups for GroupedResidualVQ (residual_vq.py:494-560)
    groups: int = 1

    @classmethod
    def tiny(cls) -> "QuantizerConfig":
        return cls(dim=64, codebook_dim=16, codebook_size=32, num_quantizers=4,
                   kmeans_iters=4)


# ---------------------------------------------------------------------------
# Audio tower (TASTE tokenizer)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AudioTowerConfig(_Base):
    """TASTE tokenizer: whisper joint encoder-segmenter + RVQ.

    Mirrors reference `TasteAudioTowerConfig` + kwargs_for_joint_encoder_segmenter
    (taslm.json: forward_type=asr_attn_pooling, is_word_level, skip_prefix_idx=4,
    make_v_proj_identity; reference taste_speech/modeling_taste.py:33-211).
    """

    whisper: WhisperConfig = field(default_factory=WhisperConfig)
    quantizer: QuantizerConfig = field(default_factory=QuantizerConfig)
    quantization_on: bool = True
    audio_embed_dim: int = 1280
    text_token_size: int = 51866
    # joint (whisper-decoder aggregation) vs legacy (alignment pooling) mode
    is_joint_encoder_segmenter: bool = True
    encoder_input_size: int = 512  # legacy-mode affine output width
    # which encoder hidden layer feeds the cross-attn V projection
    encoder_target_hidden_layer: int = 6
    skip_prefix_idx: int = 4
    is_word_level: bool = True
    fuse_forward_type: str = "asr_attn_pooling"  # or "add_and_norm"
    audio_dropout_ratio: float = 0.0
    make_v_proj_identity: bool = True
    # bf16 serving layout: keep the segmenter decoder + pooling + RVQ in
    # f32 (the encoder stays in the tower dtype) so the emitted taste
    # indices hold the BASELINE >99.9% agreement gate — RVQ argmin over
    # 512 codes flips on bf16-scale drift (docs/FULL_ARCH_PARITY.md).
    # No effect when the tower itself runs f32.
    segmenter_f32: bool = True

    @classmethod
    def tiny(cls) -> "AudioTowerConfig":
        w = WhisperConfig.tiny()
        return cls(
            whisper=w,
            quantizer=QuantizerConfig.tiny().replace(dim=w.d_model),
            audio_embed_dim=w.d_model,
            text_token_size=w.vocab_size,
            encoder_target_hidden_layer=1,
        )


# ---------------------------------------------------------------------------
# Conformer / Transformer encoder stack (speech decoder building block)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class EncoderStackConfig(_Base):
    """ESPnet/WeNet-style encoder configuration.

    Mirrors the reference speech_decoder encoder__*/llm__* fields
    (taslm.json) and cosyvoice/encoder.py:37-473.
    """

    output_size: int = 1024
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 3
    dropout_rate: float = 0.1
    positional_dropout_rate: float = 0.1
    attention_dropout_rate: float = 0.0
    input_layer: str = "linear"  # linear | linear_legacy | identity
    pos_enc_layer_type: str = "rel_pos_espnet"
    selfattention_layer_type: str = "rel_selfattn"
    normalize_before: bool = True
    # serve linear_q/k/v as ONE [d, 3d] GEMV (identical math; the small S3
    # stack's AR decode is per-op-overhead bound) — quantize with
    # quantize_encoder_params(fuse_qkv=True)
    fused_qkv_serving: bool = False
    # serve each positionwise FFN as ONE Pallas call (both projections +
    # activation, weights streamed once through VMEM; ops/pallas/fused_mlp)
    # — int4 mode packs w_2 per-tile (quantize_encoder_params(fused_mlp=True))
    fused_mlp_serving: bool = False
    static_chunk_size: int = 1  # 1 => causal LM masking
    use_cnn_module: bool = False
    cnn_module_kernel: int = 15
    cnn_module_norm: str = "batch_norm"  # batch_norm | layer_norm
    cnn_causal: bool = False
    macaron_style: bool = False
    activation_type: str = "swish"
    input_size: int = 512
    # int8 weight-only serving layout for the layer Dense kernels
    # (ops/quantized.QDense; utils/quant.quantize_encoder_params converts)
    quantized_serving: Any = False   # False | True ('int8') | 'int8' | 'int4'
    # per-layer gradient checkpointing (training memory):
    # False | True | 'dots' | 'dots_no_batch' (ops/remat.py)
    remat: Any = False

    @classmethod
    def tiny(cls, input_size: int = 32, output_size: int = 32,
             num_blocks: int = 2) -> "EncoderStackConfig":
        return cls(output_size=output_size, attention_heads=2, linear_units=64,
                   num_blocks=num_blocks, input_size=input_size)


# ---------------------------------------------------------------------------
# Speech decoder (taste -> S3 TTS LM)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SpeechDecoderConfig(_Base):
    """CosyVoice-style TTS LM (reference taslm.json speech_decoder_config;
    reference taste_speech/modeling_taste.py:214-543)."""

    text_token_size: int = 51866
    speech_token_size: int = 4096
    text_encoder_input_size: int = 512
    audio_encoder_input_size: int = 1280
    llm_input_size: int = 1024
    llm_output_size: int = 1024
    spk_embed_dim: int = 192
    skip_prefix_idx: int = 4
    lsm_weight: float = 0.0
    length_normalized_loss: bool = True
    fuse_type: str = "weighted_sum"  # concat | concat_with_sep | weighted_sum
    fuse_normalize: bool = False
    fuse_use_layer_norm: bool = False
    fuse_use_trainable_weight: bool = True
    fuse_weight_init_type: str = "balance"
    # audio units (1280-d taste embeds) are first affined down to the shared
    # encoder input size (512), then the audio conformer runs at 512->1024
    # (reference modeling_taste.py:325-340)
    text_encoder: EncoderStackConfig = field(default_factory=lambda: EncoderStackConfig(
        output_size=1024, num_blocks=3, input_size=512, input_layer="linear"))
    audio_encoder: EncoderStackConfig = field(default_factory=lambda: EncoderStackConfig(
        output_size=1024, num_blocks=2, input_size=512, input_layer="linear"))
    llm: EncoderStackConfig = field(default_factory=lambda: EncoderStackConfig(
        output_size=1024, num_blocks=7, input_size=1024, input_layer="linear_legacy"))

    @classmethod
    def tiny(cls, text_token_size: int = 1000) -> "SpeechDecoderConfig":
        return cls(
            text_token_size=text_token_size, speech_token_size=128,
            text_encoder_input_size=32, audio_encoder_input_size=64,
            llm_input_size=32, llm_output_size=32, spk_embed_dim=16,
            text_encoder=EncoderStackConfig.tiny(32, 32, 2),
            audio_encoder=EncoderStackConfig.tiny(32, 32, 2),
            llm=EncoderStackConfig.tiny(32, 32, 2).replace(input_layer="linear_legacy"),
        )


# ---------------------------------------------------------------------------
# Llama + LoRA (spoken LM backbone)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LlamaConfig(_Base):
    """Llama-3.2-1B hyperparameters (reference taslm.json text_config)."""

    vocab_size: int = 128256
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 16
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: int = 64
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    max_position_embeddings: int = 131072
    tie_word_embeddings: bool = True
    bos_token_id: int = 128000
    eos_token_id: int = 128001
    # serve base Dense kernels as int8 + per-channel scale (weight-only
    # quantization; ~1.66x AR-decode tokens/sec on v5e) — use
    # utils/quant.quantize_llama_params to convert a trained tree
    quantized_serving: Any = False   # False | True ('int8') | 'int8' | 'int4'
    # also serve the embedding table (and thus the tied lm_head) as int8
    # with per-row scales (QEmbed); "int4head" keeps int8 lookups but
    # serves the tied lm_head from a nibble-packed transposed copy through
    # the Pallas int4 kernel (halves the largest weight read of the step)
    quantized_embed_serving: Any = False  # False | True ('int8') | 'int4head'
    # serve q/k/v as ONE [H, Hq+2KV] GEMV and gate/up as one [H, 2I] GEMV:
    # the B=1 AR decode step is per-op-overhead-bound on top of its HBM
    # bytes (112 -> 64 projections/step at Llama-1B).  Requires merged LoRA
    # (use_lora=False); quantize with quantize_llama_params(fuse_qkv=True).
    # Identical math — the fused GEMV computes the same dot products.
    fused_qkv_serving: bool = False
    # serve the whole MLP (gate/up/act/down) as ONE Pallas call per layer
    # (ops/pallas/fused_mlp): the weights stream through VMEM exactly once
    # and the intermediate activation never touches HBM.  Keeps gate/up/down
    # SEPARATE in the param tree (standard quantized layout; int4 packs
    # down_proj per-tile) — quantize with
    # quantize_llama_params(fused_mlp=True).  Requires merged LoRA.
    fused_mlp_serving: bool = False
    # llama3 rope scaling
    rope_scaling_factor: float = 32.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    # per-layer gradient checkpointing (training memory):
    # False | True | 'dots' | 'dots_no_batch' (ops/remat.py)
    remat: Any = False

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        return cls(vocab_size=512, hidden_size=64, intermediate_size=128,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=16,
                   max_position_embeddings=512, rope_scaling_factor=4.0,
                   rope_original_max_position=128)


@dataclass(frozen=True)
class LoraConfig(_Base):
    """LoRA over all linear projections (reference kwargs_for_lora: r=64 a=128)."""

    r: int = 64
    alpha: int = 128
    dropout: float = 0.05
    target_linear: bool = True

    @classmethod
    def tiny(cls) -> "LoraConfig":
        return cls(r=4, alpha=8, dropout=0.0)


# ---------------------------------------------------------------------------
# Spoken LM
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SpokenLMConfig(_Base):
    """Joint text+taste LM (reference taslm.json spoken_lm_config;
    reference taste_speech/modeling_taste.py:546-1206)."""

    llama: LlamaConfig = field(default_factory=LlamaConfig)
    lora: Optional[LoraConfig] = field(default_factory=LoraConfig)
    use_lora: bool = True
    delay: int = 1
    delay_level: str = "word"  # word | token
    audio_embed_conv_mode: str = "fill_forward"
    in_llm_module: str = "weighted_sum"
    out_llm_module: str = "continue_latent_linear_last"
    loss_weights: str = "0.5-0.5"
    sos_id: int = 128000
    # KL-to-reference-model option (modeling_taste.py:968-975)
    use_text_kl: bool = False
    text_kl_weight: float = 0.9

    @classmethod
    def tiny(cls) -> "SpokenLMConfig":
        return cls(llama=LlamaConfig.tiny(), lora=LoraConfig.tiny(), sos_id=1)


# ---------------------------------------------------------------------------
# Voice generator (flow + vocoder)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FlowConfig(_Base):
    """Flow-matching acoustic model (reference
    reference taste_speech/modules_taste/cosyvoice/flow/flow.py:24-136)."""

    input_size: int = 512
    output_size: int = 80
    spk_embed_dim: int = 192
    vocab_size: int = 4096
    output_type: str = "mel"
    input_frame_rate: int = 50
    encoder: EncoderStackConfig = field(default_factory=lambda: EncoderStackConfig(
        output_size=512, attention_heads=8, linear_units=2048, num_blocks=6,
        input_size=512, input_layer="linear", static_chunk_size=0,
        use_cnn_module=False, macaron_style=False))
    # CFM
    sigma_min: float = 1e-6
    t_scheduler: str = "cosine"
    training_cfg_rate: float = 0.2
    inference_cfg_rate: float = 0.7
    n_timesteps: int = 10
    # estimator U-Net
    estimator_channels: Tuple[int, ...] = (256, 256)
    estimator_attention_head_dim: int = 64
    estimator_n_blocks: int = 4
    estimator_num_mid_blocks: int = 12
    estimator_num_heads: int = 8
    # serving-only: each U-Net transformer block as ONE Pallas call
    # (ops/pallas/fused_dit.py) — the stacks are op-latency bound at
    # estimator shapes; the training path keeps the XLA blocks
    fused_dit_serving: bool = False

    @classmethod
    def tiny(cls) -> "FlowConfig":
        return cls(input_size=32, output_size=16, spk_embed_dim=16, vocab_size=128,
                   encoder=EncoderStackConfig.tiny(32, 32, 2).replace(static_chunk_size=0),
                   estimator_channels=(32, 32), estimator_attention_head_dim=16,
                   estimator_n_blocks=1, estimator_num_mid_blocks=2,
                   estimator_num_heads=2, n_timesteps=2)


@dataclass(frozen=True)
class HiFTConfig(_Base):
    """HiFT NSF+iSTFT vocoder (reference
    reference taste_speech/modules_taste/cosyvoice/hifigan/generator.py:41-391)."""

    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 22050
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: Tuple[int, ...] = (8, 8)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 16)
    istft_n_fft: int = 16
    istft_hop_len: int = 4
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    source_resblock_kernel_sizes: Tuple[int, ...] = (7, 11)
    source_resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5), (1, 3, 5))
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99
    f0_predictor_in_channels: int = 80
    f0_predictor_cond_channels: int = 512
    # serving: route eligible ResBlock convs (stride 1, same padding,
    # channels % 128 == 0) through the Pallas tap-loop conv kernel
    # (ops/pallas/conv1d.py) — XLA's conv lowering leaves the MXU idle at
    # these narrow-channel shapes
    pallas_conv: bool = False

    @classmethod
    def tiny(cls) -> "HiFTConfig":
        return cls(in_channels=16, base_channels=32, upsample_rates=(4, 4),
                   upsample_kernel_sizes=(8, 8),
                   resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),),
                   source_resblock_kernel_sizes=(7, 11),
                   source_resblock_dilation_sizes=((1, 3), (1, 3)),
                   f0_predictor_in_channels=16, f0_predictor_cond_channels=32)


# ---------------------------------------------------------------------------
# Composite
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TasteConfig(_Base):
    """Composite configuration — reference `TasteConfig`
    (reference taste_speech/configuration_taste.py:120-202)."""

    frontend: AudioFrontendConfig = field(default_factory=AudioFrontendConfig)
    audio_tower: AudioTowerConfig = field(default_factory=AudioTowerConfig)
    speech_decoder: SpeechDecoderConfig = field(default_factory=SpeechDecoderConfig)
    spoken_lm: SpokenLMConfig = field(default_factory=SpokenLMConfig)
    flow: FlowConfig = field(default_factory=FlowConfig)
    hift: HiFTConfig = field(default_factory=HiFTConfig)
    ignore_index: int = -100

    @classmethod
    def full(cls) -> "TasteConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "TasteConfig":
        tower = AudioTowerConfig.tiny()
        return cls(
            audio_tower=tower,
            speech_decoder=SpeechDecoderConfig.tiny(
                text_token_size=tower.text_token_size).replace(
                    audio_encoder_input_size=tower.audio_embed_dim),
            spoken_lm=SpokenLMConfig.tiny(),
            flow=FlowConfig.tiny(),
            hift=HiFTConfig.tiny(),
        )


_CONFIG_TYPES = {
    c.__name__: c
    for c in (
        AudioFrontendConfig, WhisperConfig, QuantizerConfig, AudioTowerConfig,
        EncoderStackConfig, SpeechDecoderConfig, LlamaConfig, LoraConfig,
        SpokenLMConfig, FlowConfig, HiFTConfig, TasteConfig,
    )
}
