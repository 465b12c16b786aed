"""The yardstick's work counts (``perfbench/work``)."""
import pytest

from perfbench.work import b1, digital, peaks


def test_b1_hand_count_one_block_one_row():
    # one row on one case-A block: (C, D, H, W) = (2, 4, 64, 2), O = 1
    nbytes, gemm, other = b1.unified_work(1, 1, 1)
    P, taps = 4 * 2 * 32, 4 * 2 * 32 * 2
    gemm_row = taps * 2 * 16 * 8 + 2 * (
        (P // 4) * 2 * 32 * 4 + (P // 32) * 2 * 32 * 32 + 4 * 2 * 64 * 32
        + 2 * 128 * 32 + 2 * 32 * 16 + 2 * 16)
    assert gemm == gemm_row + P * 2 * 16 * 8 * 2
    other_row = taps * (4 * 16 + 3 * 8) + P * 5 * 8 + 2 * (
        (P // 4) * 4 + (P // 32) * 32 + 4 * 32 + 32 + 16)
    assert other == other_row + taps * 16 * 3 + P * 8
    n_in = 2 * 1 * 4 * 32 * 2
    n_pre = P * 2 + 2 * 16 + 8
    n_w = (16 + 2 * 16 * 8 + 32 * 4 + 4 + 32 * 32 + 32 + 64 * 32 + 32
           + 128 * 32 + 32 + 32 * 16 + 16 + 16 + 1)
    assert nbytes == 4 * (n_in + n_pre + n_w + 2)


def test_b1_rows_scale_and_lattice():
    assert b1.lattice(4096, 4096) == (16, 4096)
    assert b1.lattice(12288, 33792) == (48, 33792)
    assert b1.lattice(33792, 12288) == (132, 12288)
    one = b1.unified_work(1, 16, 4096)
    two = b1.unified_work(2, 16, 4096)
    fold = 16 * 4096 * 256 * 2 * 16 * 8 * 2
    assert two[1] - fold == 2 * (one[1] - fold)


def test_dead_rows_add_no_work():
    """A tick's rows of dead slots are no work: the readers count the live
    rows of each call (their positions), whatever the engine pads it to."""
    from perfbench.cell import metric_reader
    cfg = {"num_layers": 2, "d_model": 64, "d_ff": 128, "num_heads": 4,
           "num_kv_heads": 2, "head_dim": 16, "vocab_size": 256,
           "analog_layers": ["attn"],
           "moe": {"num_experts": 4, "top_k": 2}}
    sites = [(64, 64), (64, 32), (64, 32), (64, 64)] * 2   # q, k, v, o

    class Rec:
        start, end, max_slots = 0.0, 1.0, 8
        ticks = [(0.1, 0.2, [5, 9, 11])]          # 3 live rows of 8 slots
        prefills = []
        trace = {"b1_s": 1.0, "window_s": 1.0}

    Rec.cfg, Rec.sites = cfg, sites
    flops = b1.call_work(3, sites)[1] + digital.decode_flops(cfg, [5, 9, 11])
    assert metric_reader("mfu.tput")(Rec) == pytest.approx(
        100.0 * flops / peaks.FLOP_S)
    assert metric_reader("occupancy.tput")(Rec) == pytest.approx(37.5)
    assert b1.call_work(3, sites)[1] < b1.call_work(8, sites)[1]
    assert digital.decode_flops(cfg, []) == 0


def test_digital_hand_count():
    cfg = {"num_layers": 1, "d_model": 8, "d_ff": 16, "num_heads": 2,
           "num_kv_heads": 1, "head_dim": 4, "vocab_size": 10,
           "analog_layers": ["mlp"], "mlp_gated": True, "moe": None}
    # position 3: q.k and p.v over 4 keys; q, k, v, o digital; MLP analog
    attn = 4 * 2 * 4 * 4 + 2 * (8 * 8 + 8 * 4 + 8 * 4 + 8 * 8)
    assert digital.token_flops(cfg, 3) == attn
    moe = dict(cfg, analog_layers=["attn"], moe={"num_experts": 4,
                                                 "top_k": 2})
    expert = 2 * 8 * 16 * 3
    assert digital.token_flops(moe, 0) == 4 * 2 * 4 + 2 * 8 * 4 + 2 * expert


@pytest.mark.parametrize("by", ["ops", "bytes"])
def test_share_at_the_bound_reads_100(by):
    """A B1 time equal to the bound of the work reads 100%, whichever of
    operations and bytes bounds it."""
    M, NB, NO = (64, 16, 4096) if by == "ops" else (1, 1, 1)
    nbytes, g, o = b1.unified_work(M, NB, NO)
    t = peaks.bound_s(nbytes, g + o)
    if by == "ops":
        assert t == (g + o) / peaks.FLOP_S
    else:
        assert t == nbytes / peaks.HBM_BYTES_S
    from perfbench.cell import metric_reader

    class Rec:
        start, end = 0.0, 1.0
        ticks = [(0.1, 0.2, list(range(M)))]
        prefills = []
        sites = [(NB * 256, NO)]
        trace = {"b1_s": t, "window_s": 1.0}

    assert metric_reader("b1_roofline.tput")(Rec) == pytest.approx(100.0)
