"""Generation CLI: reconstruction and conditional completion, wav in ->
wav out (counterpart of the JAX repo's scripts/generate_audio.py).

    python -m taste_spokenlm_tpu_torch.scripts.generate_audio \\
        --seed-model ./converted --task completion --input-wav speech.wav \\
        --campplus-onnx campplus.onnx --asr-tokenizer <whisper tok dir> \\
        --llm-tokenizer <llama tok dir> --output-dir ./gen

Real audio goes through `load_audio` (the native reader and resampler,
the pure-python reader where the native one fails), the TasteProcessor
(the whisper 128-mel, the speaker fbank, the ASR transcript or --text,
dual tokenization) and the hooks from the reference's ONNX graphs
(--campplus-onnx, --s3-onnx; frontend/onnx_exec.py).  The ASR is
WhisperForASR over the audio tower with the temperature fallback.
Completion runs CompletionPipeline (the joint text + taste decode, the
tokenizer round trip, the synthesis); reconstruction runs
inference_reconstruction (SpeechAutoEncoder or SpokenLLM), or with
--use-target-speech-token vocodes given S3 tokens.  Without --input-wav
the synthetic path runs (random inputs, stand-in sampler tables), as in
JAX.  Each run writes <stem>.wav (16-bit) and <stem>.json: JAX's metadata
(task, seed, speech_tokens, samples, sample_rate, the StageTimer report,
generated_text, the sampler's settings) plus the trajectories
(generated_llm_token_ids, speech_token_ids) and joint_decode_steps.

--asr-tokenizer / --llm-tokenizer take HF tokenizer dirs (transformers is
imported only then) or "offline", a deterministic stand-in for runs
without tokenizer files (scripts/_cli.OfflineTokenizer).  Draws come from
generators seeded --seed (the decode) and --seed + 1 (the synthesis) on
--device (default CUDA; --device cpu or --platform cpu).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import wave
from typing import Dict

import numpy as np
import torch

from taste_spokenlm_tpu_torch.scripts import _cli


def write_wav(path: str, wav: np.ndarray, sr: int) -> None:
    """Mono 16-bit PCM, clipped to [-1, 1]."""
    pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype("<i2")
    with wave.open(path, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(pcm.tobytes())


def load_audio(path: str, target_sr: int) -> np.ndarray:
    """Decode and resample one file to mono float32 at `target_sr`: the
    native C++ reader and resampler (data/native.py) first; the
    pure-python RIFF reader and the torch resampler where the native
    library fails (no compiler, or a layout it does not read)."""
    import subprocess
    from taste_spokenlm_tpu_torch.data import native
    failed = (OSError, RuntimeError, subprocess.CalledProcessError)
    try:
        audio, sr = native.wav_read(path)
    except failed:
        audio, sr = native.py_wav_read(path)
    if sr != target_sr:
        try:
            audio = native.resample(audio, sr, target_sr)
        except failed:
            from taste_spokenlm_tpu_torch.ops.audio import resample
            audio = resample(torch.from_numpy(np.array(audio, np.float32))[None],
                             sr, target_sr)[0].numpy()
    return np.asarray(audio, np.float32)


def pad_or_trim_mel(mel: np.ndarray, n_frames: int) -> np.ndarray:
    """[B, n_mels, T] -> [B, n_mels, n_frames] (the tower's window)."""
    t = mel.shape[2]
    if t >= n_frames:
        return mel[:, :, :n_frames]
    return np.pad(mel, [(0, 0), (0, 0), (0, n_frames - t)])


def make_transcriber(model, asr_tokenizer, max_tokens: int = 64, seed: int = 0):
    """A whisper ASR hook on the audio tower's own encoder and decoder
    (WhisperForASR.from_tower), decoding with the temperature fallback."""
    from taste_spokenlm_tpu_torch.frontend.processor import (
        transcribe_with_fallback)
    from taste_spokenlm_tpu_torch.models.whisper import WhisperForASR
    from taste_spokenlm_tpu_torch.ops.audio import whisper_log_mel
    wcfg = model.config.audio_tower.whisper
    # the decoder's learned positions cover the prompt and the tokens
    max_tokens = min(max_tokens,
                     wcfg.max_target_positions - len(wcfg.decoder_prompt))
    asr = WhisperForASR.from_tower(model.audio_tower)
    vocab = len(asr_tokenizer) if hasattr(asr_tokenizer, "__len__") else None
    # the compression-ratio rung decodes raw ids: only with a tokenizer
    # that covers the model's vocabulary
    fb_tok = asr_tokenizer if (vocab is None or vocab >= wcfg.vocab_size) \
        else None

    def asr_apply(mel, n_tokens, temperature, generator):
        return asr(torch.as_tensor(mel).to(model.device), max_tokens=n_tokens,
                   temperature=temperature, generator=generator)

    def transcribe(audio16k: np.ndarray) -> str:
        mel = whisper_log_mel(torch.from_numpy(audio16k).to(model.device)[None],
                              n_mels=wcfg.n_mels).cpu().numpy()
        mel = pad_or_trim_mel(mel, 2 * wcfg.max_source_positions)
        tokens, _, _ = transcribe_with_fallback(
            asr_apply, mel, tokenizer=fb_tok, max_tokens=max_tokens, seed=seed)
        ids = [int(t) for t in tokens[0] if t != wcfg.eos_token_id]
        if vocab is not None:      # a seed model's ids can pass a small vocab
            ids = [t for t in ids if t < vocab]
        return asr_tokenizer.decode(ids, skip_special_tokens=True).strip()

    return transcribe


def resolve_speaker_embeds(args, processor, refs, spk_dim: int) -> np.ndarray:
    """The x-vector: the CAM++ graph over the reference clips, else
    --speaker-embed (.npy), else zeros (with a warning)."""
    if processor.speaker_embedder is not None and refs:
        return processor.speaker_embedding(refs)[None].astype(np.float32)
    if args.speaker_embed:
        emb = np.load(args.speaker_embed).astype(np.float32).reshape(1, -1)
        if emb.shape[1] != spk_dim:
            raise SystemExit(f"--speaker-embed has {emb.shape[1]} values, "
                             f"the model takes {spk_dim}")
        return emb
    print("warning: no speaker-embedding source (--campplus-onnx/"
          "--speaker-embed); using zeros", file=sys.stderr)
    return np.zeros((1, spk_dim), np.float32)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed-model", required=True)
    p.add_argument("--task", default="reconstruction",
                   choices=["reconstruction", "completion"])
    p.add_argument("--input-wav", default=None,
                   help="input audio (wav, resampled to 16 kHz); without "
                        "it the synthetic path runs")
    p.add_argument("--ref-wavs", default=None,
                   help="comma-separated speaker reference clips (default: "
                        "the input wav)")
    p.add_argument("--text", default=None,
                   help="forced text: no ASR, condition on this text")
    p.add_argument("--asr-tokenizer", default=None,
                   help="HF tokenizer dir of the whisper token space, or "
                        "'offline'")
    p.add_argument("--llm-tokenizer", default=None,
                   help="HF tokenizer dir of the llama token space, or "
                        "'offline'")
    p.add_argument("--campplus-onnx", default=None,
                   help="CAM++ x-vector graph (run by the port's executor)")
    p.add_argument("--s3-onnx", default=None,
                   help="S3 speech-tokenizer graph (real "
                        "--use-target-speech-token)")
    p.add_argument("--speaker-embed", default=None,
                   help=".npy x-vector, instead of --campplus-onnx")
    p.add_argument("--conditional-mode", default="audio",
                   choices=["audio", "text", "zero", "instruct"])
    p.add_argument("--system-prompt", default=None,
                   help="system turn of the instruct chat template")
    p.add_argument("--out-generated-part-only", action="store_true",
                   help="synthesize the generated continuation only")
    p.add_argument("--reconstruction-mode", default="SpeechAutoEncoder",
                   choices=["SpeechAutoEncoder", "SpokenLLM"])
    p.add_argument("--output-dir", required=True)
    p.add_argument("--extra-words", type=int, default=8)
    p.add_argument("--text-top-p", type=float, default=0.3)
    p.add_argument("--taste-top-p", type=float, default=0.0)
    p.add_argument("--temperature", type=float, default=0.5)
    p.add_argument("--repetition-penalty", type=float, default=1.1)
    p.add_argument("--max-speech-steps", type=int, default=64)
    p.add_argument("--max-decode-steps", type=int, default=64)
    p.add_argument("--mel-len-max", type=int, default=128)
    p.add_argument("--use-target-speech-token", action="store_true",
                   help="the S3 topline: vocode ground-truth S3 tokens "
                        "(--target-speech-tokens, --s3-onnx over "
                        "--input-wav, or random)")
    p.add_argument("--target-speech-tokens", default=None,
                   help=".npy [B, T] S3 tokens for --use-target-speech-token")
    p.add_argument("--seed", type=int, default=0)
    _cli.add_device_flags(p)
    return p


def prepare(args, model, processor, asr_tok, llm_tok, timer, p) -> Dict:
    """The model's inputs: real audio through the processor, text for a
    text / zero completion, or synthetic stand-ins.  -> {"inputs" (numpy),
    "real" (bool), "meta" (extra metadata)}."""
    cfg = model.config
    spk_dim = cfg.speech_decoder.spk_embed_dim
    n_frames = 2 * cfg.audio_tower.whisper.max_source_positions
    meta: Dict = {}
    if args.input_wav:
        if asr_tok is None or llm_tok is None:
            p.error("--input-wav needs --asr-tokenizer/--llm-tokenizer")
        sr = cfg.frontend.sample_rate
        with timer.stage("load_audio"):
            audio = load_audio(args.input_wav, sr)
            refs = ([load_audio(q, sr) for q in args.ref_wavs.split(",")]
                    if args.ref_wavs else [audio])
        text = args.text
        if text is None:
            with timer.stage("asr_transcribe", sync=model.device):
                processor.transcriber = make_transcriber(model, asr_tok,
                                                         seed=args.seed)
                text = processor.transcriber(audio)
            if not text.strip():
                print("warning: empty ASR transcript; conditioning on "
                      "'[UNK]'", file=sys.stderr)
                text = "[UNK]"
        with timer.stage("processor", sync=model.device):
            data = processor(audio, sr, text=text, ref_audio_list=(
                refs if processor.speaker_embedder else None))
            data["audio_features"] = pad_or_trim_mel(
                np.asarray(data["audio_features"]), n_frames)
            data["speaker_embeds"] = resolve_speaker_embeds(
                args, processor, refs, spk_dim)
        meta.update(orig_text=text, input_wav=args.input_wav)
        return {"inputs": data, "real": True, "meta": meta}
    if (args.task == "completion" and llm_tok is not None
            and args.conditional_mode in ("text", "zero")):
        if args.conditional_mode == "text":
            if not args.text:
                p.error("--conditional-mode text needs --text (or "
                        "--input-wav)")
            data = processor.process_text(text=args.text)
            meta["orig_text"] = args.text
        else:
            data = {}
        data["speaker_embeds"] = resolve_speaker_embeds(args, processor, [],
                                                        spk_dim)
        return {"inputs": data, "real": True, "meta": meta}
    rng = np.random.RandomState(args.seed)
    b, t_tok = 1, 8
    w = cfg.audio_tower.whisper
    words = (np.arange(t_tok) // 2)[None]
    data = {
        "speaker_embeds": rng.randn(b, spk_dim).astype(np.float32),
        "asr_token_ids": rng.randint(5, min(100, w.vocab_size), (b, t_tok)),
        "asr_token_lengths": np.asarray([t_tok]),
        "asr_word_ids": words,
        "audio_features": rng.randn(b, w.n_mels, n_frames).astype(np.float32),
    }
    v = cfg.spoken_lm.llama.vocab_size
    data.update(llm_token_ids=rng.randint(2, min(100, v), (b, t_tok)),
                llm_token_lengths=np.asarray([t_tok]), llm_word_ids=words)
    return {"inputs": data, "real": False, "meta": meta, "rng": rng}


def run(args, model, processor, asr_tok, llm_tok, timer, p) -> Dict:
    """The task on the prepared inputs -> the output arrays (numpy) and
    the metadata to add."""
    from taste_spokenlm_tpu_torch.frontend.api import CompletionPipeline
    cfg, dev = model.config, model.device
    prep = prepare(args, model, processor, asr_tok, llm_tok, timer, p)
    data, meta = prep["inputs"], dict(prep["meta"])
    x = _cli.to_device(data, dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    result: Dict = {}
    if args.task == "reconstruction" and args.use_target_speech_token:
        if args.target_speech_tokens:
            st = np.load(args.target_speech_tokens).astype(np.int64)
            st = st[None] if st.ndim == 1 else st
        elif "speech_token_ids" in data:
            st = np.asarray(data["speech_token_ids"], np.int64)
        else:      # the synthetic inputs' stream goes on, as in JAX
            st = prep.get("rng", np.random.RandomState(args.seed)).randint(
                0, cfg.speech_decoder.speech_token_size,
                (1, args.max_speech_steps))
        st_t = torch.from_numpy(st).to(dev)
        with timer.stage("s3_topline_vocode", sync=dev):
            out = model.vocode(st_t, torch.full((st.shape[0],), st.shape[1],
                                                device=dev),
                               x["speaker_embeds"], mel_len_max=args.mel_len_max,
                               generator=gen)
    elif args.task == "reconstruction":
        lm_kwargs = {}
        if args.reconstruction_mode == "SpokenLLM":
            if "llm_token_ids" not in x:
                p.error("SpokenLLM reconstruction needs llm tokens (give "
                        "--llm-tokenizer with --input-wav)")
            lm_kwargs = {k: x[k] for k in ("llm_token_ids",
                                           "llm_token_lengths", "llm_word_ids")}
        with timer.stage("reconstruction", sync=dev):
            out = model.inference_reconstruction(
                x["speaker_embeds"], x["asr_token_ids"], x["asr_token_lengths"],
                x["asr_word_ids"], x["audio_features"],
                mode=args.reconstruction_mode,
                max_speech_steps=args.max_speech_steps,
                mel_len_max=args.mel_len_max, generator=gen, **lm_kwargs)
    elif prep["real"]:
        if args.conditional_mode in ("audio", "instruct"):
            with timer.stage("extract_vq", sync=dev):
                _, llm_indices = model.extract_vq(
                    x["asr_token_ids"], x["asr_token_lengths"],
                    x["asr_word_ids"], x["llm_token_ids"],
                    x["llm_token_lengths"], x["llm_word_ids"],
                    x["audio_features"])
            llm_indices = llm_indices.cpu().numpy()
        else:
            if "llm_token_ids" not in data:
                data.update(llm_token_ids=np.zeros((1, 1), np.int32),
                            llm_word_ids=np.zeros((1, 1), np.int32))
            n_levels = cfg.audio_tower.quantizer.num_quantizers
            llm_indices = np.full((1, data["llm_token_ids"].shape[1], n_levels),
                                  -1, np.int32)
        pipe = CompletionPipeline(
            model, llm_tokenizer=llm_tok, asr_tokenizer=asr_tok,
            max_decode_steps=args.max_decode_steps,
            max_speech_steps=args.max_speech_steps,
            mel_len_max=args.mel_len_max)
        # the pipeline keeps the decode's step count to itself: read it
        # from the decode's output on its way through
        decoded = {}

        def decode(*a, **kw):
            decoded.update(model.__class__.generate_completion(model, *a, **kw))
            return decoded
        model.generate_completion = decode
        try:
            with timer.stage("completion", sync=dev):
                res = pipe(
                    np.asarray(data["speaker_embeds"]),
                    np.asarray(data["llm_token_ids"]),
                    np.asarray(data["llm_word_ids"]), llm_indices,
                    asr_token_ids=data.get("asr_token_ids"),
                    asr_word_ids=data.get("asr_word_ids"),
                    conditional_mode=args.conditional_mode,
                    out_generated_part_only=args.out_generated_part_only,
                    extra_words=args.extra_words, text_top_p=args.text_top_p,
                    taste_top_p=args.taste_top_p, temperature=args.temperature,
                    repetition_penalty=args.repetition_penalty,
                    seed=args.seed, system_prompt=args.system_prompt)
        finally:
            del model.generate_completion
        meta["generated_text"] = res["generated_text"]
        result["generated_llm_token_ids"] = res["generated_llm_token_ids"]
        result["joint_decode_steps"] = int(decoded["steps"])
        out = {k: res[k] for k in ("speech_token_ids", "speech_token_lengths",
                                   "waveform", "waveform_lengths")}
    else:
        out = _synthetic_completion(args, model, x, gen, prep["rng"], timer,
                                    result)
    result.update({k: (v.float().cpu().numpy() if isinstance(v, torch.Tensor)
                       else np.asarray(v)) for k, v in out.items()})
    result["meta"] = meta
    return result


def _synthetic_completion(args, model, x, gen, rng, timer, result):
    """The synthetic completion (no tokenizers): the joint decode with
    stand-in tables, then the synthesis of its taste rows."""
    from taste_spokenlm_tpu_torch.models.sampler import SamplerConfig
    cfg, dev = model.config, model.device
    v = cfg.spoken_lm.llama.vocab_size
    tables = {"word_start": torch.from_numpy(np.arange(v) % 3 == 0).to(dev),
              "banned": torch.zeros((v,), dtype=torch.bool, device=dev),
              "sentence_end": torch.from_numpy(np.arange(v) % 7 == 0).to(dev)}
    t_tok = x["llm_token_ids"].shape[1]
    _, llm_idx = model.extract_vq(
        x["asr_token_ids"], x["asr_token_lengths"], x["asr_word_ids"],
        x["llm_token_ids"], x["llm_token_lengths"], x["llm_word_ids"],
        x["audio_features"])
    scfg = SamplerConfig(
        delay=cfg.spoken_lm.delay, delay_level=cfg.spoken_lm.delay_level,
        extra_words=args.extra_words, text_top_p=args.text_top_p,
        taste_top_p=args.taste_top_p, text_temperature=args.temperature,
        repetition_penalty=args.repetition_penalty,
        has_prefix=args.conditional_mode in ("audio", "instruct"))
    instruct = {}
    if args.conditional_mode == "instruct":
        # stand-in template ids (real ones come from build_instruct_ids
        # when --llm-tokenizer is given)
        instruct = dict(
            instruct_prefix_ids=torch.from_numpy(
                rng.randint(2, min(100, v), (4,))).to(dev),
            instruct_suffix_ids=torch.from_numpy(
                rng.randint(2, min(100, v), (3,))).to(dev))
    zero = args.conditional_mode == "zero"
    with timer.stage("completion_decode", sync=dev):
        dec = model.generate_completion(
            scfg, tables, None if zero else llm_idx,
            None if zero else x["llm_token_ids"],
            None if zero else x["llm_token_lengths"],
            None if zero else x["llm_word_ids"], args.conditional_mode,
            args.max_decode_steps, **instruct, generator=gen)
    n = int(dec["num_tokens"][0])
    result["generated_llm_token_ids"] = dec["llm_token_ids"][0, :n].cpu().numpy()
    result["joint_decode_steps"] = int(dec["steps"])
    n_words = max(int(dec["num_taste_words"][0]), 1)
    taste = dec["taste_indices"][:, :n_words].clamp(min=0)
    words = torch.from_numpy(np.arange(t_tok) % n_words)[None].to(dev)
    with timer.stage("synthesis", sync=dev):
        return model.synthesize_from_taste(
            x["speaker_embeds"], taste, x["asr_token_ids"],
            x["asr_token_lengths"], words,
            max_speech_steps=args.max_speech_steps,
            mel_len_max=args.mel_len_max,
            generator=torch.Generator(device=dev).manual_seed(args.seed + 1))


def main(argv=None) -> Dict:
    p = parser()
    args = p.parse_args(argv)
    if args.use_target_speech_token and args.task != "reconstruction":
        p.error("--use-target-speech-token is a reconstruction-task "
                "ablation; combine it with --task reconstruction")
    if args.use_target_speech_token and \
            args.reconstruction_mode != "SpeechAutoEncoder":
        p.error("--use-target-speech-token bypasses the LM and cannot be "
                "combined with --reconstruction-mode SpokenLLM")

    from taste_spokenlm_tpu_torch.frontend.processor import (
        s3_tokenizer_from_onnx, speaker_embedder_from_onnx)
    from taste_spokenlm_tpu_torch.pretrained import from_pretrained, load_config
    from taste_spokenlm_tpu_torch.utils.profiling import StageTimer

    dev = _cli.device_from(args)
    asr_tok, llm_tok = _cli.load_tokenizers(
        args.asr_tokenizer, args.llm_tokenizer, load_config(args.seed_model))
    model, processor = from_pretrained(
        args.seed_model, llm_tokenizer=llm_tok, asr_tokenizer=asr_tok,
        device=dev)
    if args.campplus_onnx:
        processor.speaker_embedder = speaker_embedder_from_onnx(
            args.campplus_onnx, device=dev)
    if args.s3_onnx:
        processor.s3_tokenizer = s3_tokenizer_from_onnx(args.s3_onnx,
                                                        device=dev)
    os.makedirs(args.output_dir, exist_ok=True)
    timer = StageTimer()
    res = run(args, model, processor, asr_tok, llm_tok, timer, p)

    cfg = model.config
    sr = cfg.hift.sampling_rate
    wav = res["waveform"][0]
    n = int(res["waveform_lengths"][0]) or len(wav)
    stem = (os.path.splitext(os.path.basename(args.input_wav))[0]
            if args.input_wav else f"{args.task}_{args.seed}")
    write_wav(os.path.join(args.output_dir, f"{stem}.wav"), wav[:n], sr)
    n_s3 = int(res["speech_token_lengths"][0])
    meta = {"task": args.task, "seed": args.seed, **res["meta"],
            "speech_tokens": n_s3, "samples": n, "sample_rate": sr,
            "timing": timer.report(audio_seconds=n / sr),
            "speech_token_ids": res["speech_token_ids"][0, :n_s3]
            .astype(np.int64).tolist()}
    if "generated_llm_token_ids" in res:
        meta["generated_llm_token_ids"] = \
            res["generated_llm_token_ids"].astype(np.int64).tolist()
        meta["joint_decode_steps"] = int(res["joint_decode_steps"])
    if args.task == "completion":
        meta.update({
            "conditional_mode": args.conditional_mode,
            "extra_words": args.extra_words,
            "text_top_p": args.text_top_p,
            "taste_top_p": args.taste_top_p,
            "text_temperature": args.temperature,
            "repetition_penalty": args.repetition_penalty,
        })
    with open(os.path.join(args.output_dir, f"{stem}.json"), "w") as f:
        json.dump(meta, f, ensure_ascii=False, indent=2)
    print(json.dumps({k: v for k, v in meta.items()
                      if k not in ("speech_token_ids",
                                   "generated_llm_token_ids")},
                     ensure_ascii=False), flush=True)
    return meta


if __name__ == "__main__":
    main()
