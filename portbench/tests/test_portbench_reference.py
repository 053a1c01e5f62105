"""The frozen copies in portbench/reference compute what the port's plain
path computes: at TasteConfig.tiny() in float32 on the CPU, on the same
seeded weights, the tower, the S3 decoder's teacher-forced forward, the
flow and HiFT agree with the port's modules (the reference's kernel
routes are off; on the CPU the port runs its kernels' plain versions)."""

import pytest
import torch

from portbench import inputs
from portbench.reference import pipeline


@pytest.fixture(scope="module")
def pair():
    from taste_spokenlm_tpu_torch.config import TasteConfig
    from taste_spokenlm_tpu_torch.models.taste import TasteForCausalLM
    cfg = TasteConfig.tiny()
    with torch.device("meta"):
        meta = TasteForCausalLM(cfg, device="meta")
    sd = inputs.seeded_state_dict(meta, 11, "cpu")
    prog = TasteForCausalLM(cfg, device="cpu")
    prog.load_state_dict(sd, strict=True)
    ref = pipeline.build(pipeline.reference_config(cfg.to_dict()), sd)
    return cfg, prog.eval(), ref


def _inputs(cfg):
    g = torch.Generator().manual_seed(3)
    w = cfg.audio_tower.whisper
    wav = inputs.speech_like([1.0, 1.5], inputs.window_samples(w), g, "cpu")
    mel = inputs.whisper_log_mel(wav, w.n_mels)
    ids, lengths, words = inputs.token_rows([3, 5], 5, w.vocab_size, g, "cpu")
    return mel, ids, lengths, words


def test_tower_matches(pair):
    cfg, prog, ref = pair
    mel, ids, lengths, words = _inputs(cfg)
    with torch.no_grad():
        a = prog.audio_tower(mel, ids, lengths, words)
        b = ref["tower"](mel, ids, lengths, words)
    assert torch.equal(a["quantized_indices"], b["quantized_indices"])
    torch.testing.assert_close(a["audio_unit_embeds"], b["audio_unit_embeds"],
                               rtol=1e-6, atol=1e-6)
    z = prog.audio_tower.vq.rvq.project_in(
        prog.audio_tower._segment(mel, ids, lengths, words))
    assert pipeline.tower_err(ref["tower"], mel, ids, lengths, words,
                              a["quantized_indices"], z) < 1e-6


def test_s3_and_voice_match(pair):
    cfg, prog, ref = pair
    mel, ids, lengths, words = _inputs(cfg)
    g = torch.Generator().manual_seed(4)
    spk = torch.randn(2, cfg.speech_decoder.spk_embed_dim, generator=g)
    s3_ids = torch.randint(0, cfg.speech_decoder.speech_token_size, (2, 7),
                           generator=g)
    s3_len = torch.tensor([7, 4])
    with torch.no_grad():
        emb = prog.audio_tower(mel, ids, lengths, words)["audio_unit_embeds"]
        a = prog.speech_decoder(spk, emb, lengths, ids, lengths, s3_ids,
                                s3_len)
        b = ref["s3"](spk, emb, lengths, ids, lengths, s3_ids, s3_len)
        torch.testing.assert_close(a["logits"], b["logits"], rtol=1e-6,
                                   atol=1e-6)
        z = torch.randn(2, 24, cfg.flow.output_size, generator=g)
        ma, la = prog.voice_generator.flow.inference(s3_ids, s3_len, spk, 24,
                                                     z=z)
        mb, lb = ref["voice"].flow.inference(s3_ids, s3_len, spk, 24, z=z)
        torch.testing.assert_close(ma, mb, rtol=1e-6, atol=1e-6)
        h = cfg.hift.nb_harmonics + 1
        spf = ref["voice"].hift.config.istft_hop_len
        for u in cfg.hift.upsample_rates:
            spf *= u
        phase = torch.rand(2, h, 1, generator=g)
        noise = torch.randn(2, h, 24 * spf, generator=g)
        wa = prog.voice_generator.hift(ma, phase, noise)
        wb = ref["voice"].hift(ma, phase, noise)
        torch.testing.assert_close(wa, wb, rtol=1e-6, atol=1e-6)
