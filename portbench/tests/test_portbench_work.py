"""Work counts on hand-worked shapes: what the inputs need, no padding."""

from portbench.work import counts, peaks


def test_k3_counts_real_frames_and_distinct_pdfs():
    w = counts.k3(frames=10, pdfs=3, gauss=2, dim=4)
    # 10 frames x 3 pdfs x 2 Gaussians x (2 x 2 x 4 + 2): a multiply-add
    # is two operations
    assert w.flops == 1080
    # features 10 x 4, pdf rows 3 x 2 x (2 x 4 + 1), emissions 10 x 3; float32
    assert w.bytes == (40 + 54 + 30) * 4


def test_k1_counts_real_arcs_and_steps():
    w = counts.k1(frames=5, states=3, arcs=7)
    assert w.flops == 2 * 7 * 4
    assert w.bytes == 5 * 3 * 4 + 3 * 4
    assert counts.k1(frames=1, states=3, arcs=7).flops == 0


def test_batches_add_rows_not_padding():
    rows = [(10, 3), (4, 2)]
    total = counts.Work()
    for frames, pdfs in rows:
        total += counts.k3(frames, pdfs, 2, 4)
    padded = counts.k3(10, 3, 2, 4) * 2
    assert total.flops < padded.flops
    assert total.flops == (10 * 3 + 4 * 2) * 2 * 18


def test_whisper_decoder_step():
    w = counts.whisper_decoder_step(d=4, layers=1, ffn=8, vocab=10, positions=6, past=2)
    macs = (4 * 16 + 2 * 3 * 4 + 2 * 16 + 2 * 6 * 4 + 2 * 4 * 8) + 4 * 10
    assert w.flops == 2 * macs
    weights = (4 * 16 + 2 * 16 + 2 * 4 * 8) + 10 * 4
    assert w.bytes == weights * 2 + (2 * 3 * 4 + 2 * 6 * 4) * 4


def test_whisper_encoder():
    w = counts.whisper_encoder(d=4, layers=1, ffn=8, mels=2, positions=3)
    macs = 6 * 4 * 2 * 3 + 3 * 16 * 3 + (4 * 3 * 16 + 2 * 9 * 4 + 2 * 3 * 4 * 8)
    assert w.flops == 2 * macs
    weights = 4 * 2 * 3 + 16 * 3 + (4 * 16 + 2 * 4 * 8)
    assert w.bytes == weights * 2 + (2 * 6 + 3 * 4) * 4


def test_mfcc_frames():
    assert counts.mfcc_frames(16000) == 100
    assert counts.mfcc_frames(16079) == 100
    assert counts.mfcc_frames(16080) == 101


def test_bound_is_the_larger_of_two():
    assert peaks.bound_s(peaks.FP32_ACCURATE_FLOP_PER_S, 0) == 1.0
    assert peaks.bound_s(0, peaks.HBM_BYTES_PER_S * 2) == 2.0
    assert peaks.FP32_ACCURATE_FLOP_PER_S == 165e12
