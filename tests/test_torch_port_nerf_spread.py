"""``benchmarks.nerf_psnr_spread``: its defaults are chip_smoke's NeRF
check (steps, rays, seeds, the per-run floor), and its summary counts the
runs under the floor and spreads the PSNRs by seed. The runs themselves
need the card."""

import sys
from pathlib import Path

import pytest

from tcnn_tpu_torch.benchmarks import nerf_psnr_spread as ps

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def test_defaults_are_chip_smokes_nerf_check():
    args = ps.build_parser().parse_args([])
    assert (args.steps, args.rays) == (chip_smoke.NERF_STEPS, chip_smoke.NERF_RAYS)
    assert tuple(int(s) for s in args.seeds.split(",")) == chip_smoke.NERF_SEEDS
    assert args.floor == chip_smoke.NERF_RUN_PSNR_FLOOR and args.device == "cuda"


def test_summary_counts_the_runs_under_the_floor():
    psnrs = {0: [40.0, 34.5, 52.0], 4: [35.0, 60.25]}
    got = ps.summarize(psnrs, 35.0)
    assert got["runs"] == 5 and got["n_under"] == 1 and got["under_floor"] == [(0, 1, 34.5)]
    assert got["share_under"] == pytest.approx(0.2)
    assert got["all"] == {"min": 34.5, "median": 40.0, "max": 60.25}
    assert got["by_seed"][0] == {"min": 34.5, "median": 40.0, "max": 52.0}
    assert got["by_seed"][4] == {"min": 35.0, "median": 47.625, "max": 60.25}
