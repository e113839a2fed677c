"""chip_smoke.py's phases at small sizes on the CPU, and its device gate.

On the card the script runs these phases at full size; here they run on
the CPU backend (and a 4-device slice of the virtual CPU mesh) so that
their checks and control flow are exercised by every test run.
"""

import numpy as np
import pytest

import chip_smoke
from jpeg_encoder_tpu.parallel import mesh as mesh_lib


def test_device_gate_refuses_cpu():
    with pytest.raises(chip_smoke.SmokeError, match="not 'gpu'"):
        chip_smoke.phase_device("gpu")


def test_main_without_gpu_exits_before_any_result(capsys):
    with pytest.raises(chip_smoke.SmokeError):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_colour_phase_cpu():
    assert "0 mismatches" in chip_smoke.phase_colour(step=15)


def test_dct_phase_cpu():
    detail = chip_smoke.phase_dct(n_blocks=4096)
    assert detail.startswith("4096 blocks")


def test_mixed_blocks_cover_every_content_class():
    blocks = chip_smoke.mixed_blocks(400, seed=1)
    assert blocks.shape == (400, 8, 8) and blocks.dtype == np.uint8
    flat = blocks[200:300].reshape(100, 64)
    assert (flat == flat[:, :1]).all()
    assert set(np.unique(blocks[300:])) <= {0, 255}


def test_files_phase_cpu(tmp_path):
    detail = chip_smoke.phase_files(
        str(tmp_path), hd=(32, 48), uhd=(48, 64), n_hd=2, n_uhd=1
    )
    assert "byte-identical" in detail


def test_aot_phase_fails_when_no_artifact_loads(tmp_path):
    """On the 8-device CPU test mesh the AOT cache declines to build, so
    the phase must fail rather than pass on plain jit dispatch."""
    with pytest.raises(chip_smoke.SmokeError, match="AOT artifacts"):
        chip_smoke.phase_aot(str(tmp_path), size=(32, 32))


def test_four_card_phases_cpu():
    mesh = mesh_lib.data_mesh(4)
    assert "byte-identical" in chip_smoke.phase_batch_dp(
        mesh, hd=(32, 48), n=8
    )
    assert "byte-identical" in chip_smoke.phase_tiled(
        mesh, width=64, even_height=64, restart=4
    )
    assert "byte-identical" in chip_smoke.phase_tiled_optimize(
        mesh, height=48, width=64
    )
