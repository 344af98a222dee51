"""The port's NeuraSim (``repro_torch.neurasim``) against the reference's
(``repro.neurasim``) on the CPU: the Table-1 graphs and machine tables,
``stats_from_coo`` field by field (row tags included, sampled or not) on
the reference tests' four graphs, ``powerlaw_graph(256, 1024, seed=4)``
and an A·B with B ≠ A, ``mapping_loads`` for the four mappings, every
``SimResult`` field for Tile-4/16/64 under both evictions, the CPI
samples and ``stats_spmm_dense``; then the reference's seven
``test_neurasim.py`` tests and ``test_symbolic_pp_matches_neurasim_walk``
run against the port."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.data.synthetic import powerlaw_graph as j_powerlaw
from repro.neurasim import datasets as JD
from repro.neurasim import machine as JMa
from repro.neurasim import model as JM
from repro_torch.data.synthetic import powerlaw_graph
from repro_torch.neurasim import datasets, machine, model
from repro_torch.sparse.spgemm import symbolic

CPU = "cpu"
GRAPHS = ("wiki-Vote", "facebook", "p2p-Gnutella31", "poisson3Da")
MAPPINGS = ("ring", "modular", "random", "drhm")


def _pair(name):
    s, r, n = datasets.synth(name)
    return (s, r, n), model.stats_from_coo(s, r, n, device=CPU), \
        JM.stats_from_coo(s, r, n)


@pytest.fixture(scope="module")
def pairs():
    return {name: _pair(name) for name in GRAPHS}


@pytest.fixture(scope="module")
def workloads(pairs):
    return [pairs[name][1] for name in GRAPHS]


def _same_stats(w, wj):
    assert (w.n_rows, w.nnz_a, w.pp_interim, w.nnz_out) == \
        (wj.n_rows, wj.nnz_a, wj.pp_interim, wj.nnz_out)
    assert w.row_tags.dtype == torch.int64
    np.testing.assert_array_equal(w.row_tags.numpy(), wj.row_tags)


def test_tables_equal():
    assert datasets.TABLE1 == JD.TABLE1
    assert datasets.FAST_SET == JD.FAST_SET
    for name, cfg in machine.CONFIGS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            JMa.CONFIGS[name])
        assert cfg.peak_gflops == JMa.CONFIGS[name].peak_gflops
    assert machine.PUBLISHED_GOPS == JMa.PUBLISHED_GOPS
    assert machine.PAPER_NEURACHIP_GOPS == JMa.PAPER_NEURACHIP_GOPS
    for k in ("MMH4_CYCLES", "HACC_CYCLES", "COLLISION_PENALTY",
              "BYTES_PER_NNZ", "B_STREAM_BYTES", "PAD_EXP", "COMP_EXP",
              "QUEUE_OVERHEAD", "RHO", "ETA"):
        assert getattr(model, k) == getattr(JM, k), k


@pytest.mark.parametrize("name", GRAPHS)
def test_synth_and_stats_equal(pairs, name):
    (s, r, n), w, wj = pairs[name]
    sj, rj, nj = JD.synth(name)
    np.testing.assert_array_equal(s, sj)
    np.testing.assert_array_equal(r, rj)
    _same_stats(w, wj)


def test_stats_powerlaw_and_a_times_b():
    s, r = powerlaw_graph(256, 1024, seed=4)
    sj, rj = j_powerlaw(256, 1024, seed=4)
    np.testing.assert_array_equal(s, sj)
    s, r = s.astype(np.int64), r.astype(np.int64)
    _same_stats(model.stats_from_coo(s, r, 256, device=CPU),
                JM.stats_from_coo(s, r, 256))
    # A (300 × 256) times B (256 × 190), B ≠ A
    rng = np.random.default_rng(5)
    ar, ac = rng.integers(0, 300, 2000), rng.integers(0, 256, 2000)
    br, bc = rng.integers(0, 256, 1500), rng.integers(0, 190, 1500)
    _same_stats(model.stats_from_coo(ar, ac, 300, br, bc, 256, device=CPU),
                JM.stats_from_coo(ar, ac, 300, br, bc, 256))


def test_stats_sampled_row_tags(pairs):
    (s, r, n), _, _ = pairs["facebook"]
    w = model.stats_from_coo(s, r, n, sample_cap=5000, device=CPU)
    wj = JM.stats_from_coo(s, r, n, sample_cap=5000)
    assert w.row_tags.numel() == 5000
    _same_stats(w, wj)


@pytest.mark.parametrize("mapping", MAPPINGS)
@pytest.mark.parametrize("n_units", [8, 32, 128])
def test_mapping_loads_equal(pairs, mapping, n_units):
    for name in GRAPHS:
        _, w, wj = pairs[name]
        got = model.mapping_loads(w.row_tags, n_units, mapping, device=CPU)
        np.testing.assert_array_equal(
            got.numpy(), JM.mapping_loads(wj.row_tags, n_units, mapping))
        assert model.imbalance_factor(got) == JM.imbalance_factor(
            JM.mapping_loads(wj.row_tags, n_units, mapping))
    tags = (np.arange(300_000) * 32) % (1 << 16)     # stride-adversarial
    for kw in ({}, {"seed": 3}):
        np.testing.assert_array_equal(
            model.mapping_loads(tags, n_units, mapping, device=CPU,
                                **kw).numpy(),
            JM.mapping_loads(tags, n_units, mapping, **kw))


@pytest.mark.parametrize("cname", sorted(machine.CONFIGS))
@pytest.mark.parametrize("eviction", ["rolling", "barrier"])
def test_simulate_spgemm_fields_equal(pairs, cname, eviction):
    for name in GRAPHS:
        _, w, wj = pairs[name]
        for mapping in MAPPINGS:
            got = model.simulate_spgemm(w, machine.CONFIGS[cname], mapping,
                                        eviction)
            want = JM.simulate_spgemm(wj, JMa.CONFIGS[cname], mapping,
                                      eviction)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), \
                (name, mapping)


def test_cpi_samples_equal():
    for cname, cfg in machine.CONFIGS.items():
        for k in (1, 2, 4, 8):
            np.testing.assert_array_equal(
                model.sample_mmh_cpi(k, cfg, n=5000, seed=k),
                JM.sample_mmh_cpi(k, JMa.CONFIGS[cname], n=5000, seed=k))
        for ev in ("rolling", "barrier"):
            for occ in (0.3, 0.6, 0.99):
                np.testing.assert_array_equal(
                    model.sample_hacc_cpi(ev, cfg, n=5000, occupancy=occ),
                    JM.sample_hacc_cpi(ev, JMa.CONFIGS[cname], n=5000,
                                       occupancy=occ))


def test_stats_spmm_dense_equal(pairs):
    (s, r, n), _, _ = pairs["facebook"]
    _same_stats(model.stats_spmm_dense(s, r, n, 16, device=CPU),
                JM.stats_spmm_dense(s, r, n, 16))
    big = np.tile(s, 40)                       # past the 2M tag sample
    _same_stats(model.stats_spmm_dense(big, big, n, 3, device=CPU),
                JM.stats_spmm_dense(big, big, n, 3))


def test_entry_points_ask_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.stats_from_coo(np.array([0]), np.array([0]), 1)


# --- the reference's test_neurasim.py, against the port -------------------

def test_calibration_band(workloads):
    for cname, cfg in machine.CONFIGS.items():
        avg = np.mean([model.simulate_spgemm(w, cfg).gops for w in workloads])
        paper = machine.PAPER_NEURACHIP_GOPS[cname]
        assert 0.6 * paper < avg < 1.6 * paper, (cname, avg, paper)


def test_tile_ordering_matches_paper(workloads):
    g = {c: np.mean([model.simulate_spgemm(w, cfg).gops for w in workloads])
         for c, cfg in machine.CONFIGS.items()}
    assert g["tile4"] < g["tile16"] <= g["tile64"] * 1.05
    t64b = dataclasses.replace(machine.TILE64, dram_bw_gbps=256.0)
    g64b = np.mean([model.simulate_spgemm(w, t64b).gops for w in workloads])
    assert g64b > 1.5 * g["tile64"]


def test_drhm_mapping_flattest_on_patterned():
    tags = (np.arange(300_000) * 32) % (1 << 16)
    imb = {m: model.imbalance_factor(
        model.mapping_loads(tags, 32, m, device=CPU)) for m in MAPPINGS}
    assert imb["drhm"] < 0.25 * imb["ring"]
    assert imb["drhm"] < 1.5 * imb["random"]


def test_rolling_beats_barrier(workloads):
    w = workloads[0]
    roll = model.simulate_spgemm(w, machine.TILE16, eviction="rolling")
    barr = model.simulate_spgemm(w, machine.TILE16, eviction="barrier")
    assert roll.cycles < barr.cycles


def test_hacc_rolling_cpi_lower():
    r = model.sample_hacc_cpi("rolling", machine.TILE16, occupancy=0.6)
    b = model.sample_hacc_cpi("barrier", machine.TILE16, occupancy=0.6)
    assert r.mean() < 0.6 * b.mean()


def test_mmh4_is_sweet_spot():
    cpis = {k: model.sample_mmh_cpi(k, machine.TILE16).mean() / (k * 4)
            for k in (1, 2, 4, 8)}
    assert cpis[4] == min(cpis.values())


def test_speedup_headlines(pairs):
    ws = [pairs["poisson3Da"][1], pairs["facebook"][1], pairs["wiki-Vote"][1]]
    sg, rg, ng = datasets.synth("scircuit")
    ws.append(model.stats_from_coo(sg, rg, ng, device=CPU))
    t16 = np.mean([model.simulate_spgemm(w, machine.TILE16).gops for w in ws])
    mkl = t16 / machine.PUBLISHED_GOPS["Xeon E5 (MKL)"]
    gamma = t16 / machine.PUBLISHED_GOPS["Gamma"]
    assert 0.55 * 22.1 < mkl < 1.45 * 22.1
    assert 0.55 * 1.5 < gamma < 1.45 * 1.5


def test_symbolic_pp_matches_neurasim_walk():
    """The port's SpGEMM symbolic phase against the port's NeuraSim walk."""
    s, r = powerlaw_graph(256, 1024, seed=4)
    sym = symbolic(s, r, 256, s, r, 256)
    w = model.stats_from_coo(s.astype(np.int64), r.astype(np.int64), 256,
                             device=CPU)
    assert sym.pp_interim == w.pp_interim
    assert sym.nnz_out == w.nnz_out
