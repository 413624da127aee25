"""The port's ``tools/calibrate_qscores.py`` (a copy of the JAX package's):
JAX's tests/test_calibrate.py cases on the port's copy, and the fit and the
rewritten config.toml equal to JAX's on one FASTQ + PAF fixture; the
module runs as ``python -m xna_basecaller_tpu_torch.tools.calibrate_qscores``."""

import numpy as np
import pytest

from xna_basecaller_tpu_torch.tools.calibrate_qscores import (
    apply_to_config, collect_calibration_pairs, fit_calibration,
    per_base_correct,
)


def test_per_base_correct_ops():
    #        0123456789
    # read:  AACGTTAGGC  with cs  :2 *ga +gg :3 -tt :2  starting at q0=0
    # matches: 0,1 | sub: 2 | ins: 3,4 | matches 5,6,7 | del | matches 8,9
    aligned, correct = per_base_correct(":2*ga+gg:3-tt:2", 0, 10)
    np.testing.assert_array_equal(aligned, [1] * 10)
    np.testing.assert_array_equal(
        correct, [1, 1, 0, 0, 0, 1, 1, 1, 1, 1])


def test_per_base_correct_clipped():
    aligned, correct = per_base_correct(":3", 2, 8)
    np.testing.assert_array_equal(aligned, [0, 0, 1, 1, 1, 0, 0, 0])
    np.testing.assert_array_equal(correct, aligned)


def test_collect_reverse_strand():
    # read of length 6, aligned '-': cs runs on the revcomp orientation
    reads = {"r1": ("ACGTAC", "!#%')+")}  # q = 0,2,4,6,8,10
    rec = dict(read_id="r1", read_length=6, read_start=0, read_end=5,
               strand="-", cs=":2*at:2")
    q, correct = collect_calibration_pairs(reads, [rec])
    # aligned orientation: revcomp coords; q0 = 6 - 5 = 1; cs covers the 5
    # bases at revcomp idx 1..5 = forward idx 0..4 -> q values 0,2,4,6,8
    np.testing.assert_array_equal(sorted(q), [0, 2, 4, 6, 8])
    assert correct.sum() == 4  # one substitution among 5 aligned bases


def test_fit_recovers_known_miscalibration():
    rng = np.random.default_rng(0)
    alpha_true, beta_true = 2.0, -4.0
    qs, ok = [], []
    for q_emit in range(5, 20):
        q_true = alpha_true * q_emit + beta_true
        p_err = 10 ** (-q_true / 10)
        n = 20000
        qs.append(np.full(n, q_emit, np.int32))
        ok.append(rng.random(n) > p_err)
    fit = fit_calibration(np.concatenate(qs), np.concatenate(ok))
    assert abs(fit["alpha"] - alpha_true) < 0.15, fit
    assert abs(fit["beta"] - beta_true) < 1.5, fit
    assert len(fit["table"]) == 15


def test_apply_to_config(tmp_path):
    from xna_basecaller_tpu_torch.core import config as config_lib
    from xna_basecaller_tpu_torch.core.config import ModelConfig

    d = str(tmp_path)
    config_lib.save(ModelConfig(), d)
    cfg0 = config_lib.load(d)
    scale, bias = apply_to_config(d, alpha=2.0, beta=-4.0)
    assert scale == 2.0 * cfg0.qscore.scale
    assert bias == 2.0 * cfg0.qscore.bias - 4.0
    cfg = config_lib.load(d)
    assert cfg.qscore.scale == scale and cfg.qscore.bias == bias


def _fixture(tmp_path, reverse=False):
    """60 reads of 80 bases whose qualities are calibrated by construction,
    their FASTQ and their PAF with cs tags (every other one on '-' where
    ``reverse``)."""
    from xna_basecaller_tpu_torch.eval.ref_align import write_paf

    rng = np.random.default_rng(1)
    fastq = tmp_path / "r.fastq"
    recs = []
    with open(fastq, "w") as fh:
        for i in range(60):
            n = 80
            seq = "".join("ACGT"[j] for j in rng.integers(0, 4, n))
            q = rng.integers(3, 15, n)
            # each base errs with exactly its stated probability, so the
            # emitted qualities are perfectly calibrated by construction
            err_pos = np.flatnonzero(rng.random(n) < 10.0 ** (-q / 10))
            # cs: runs of matches with substitutions at err_pos
            parts, prev = [], 0
            for p in err_pos:
                if p > prev:
                    parts.append(f":{p - prev}")
                parts.append("*ga")
                prev = p + 1
            if n > prev:
                parts.append(f":{n - prev}")
            recs.append(dict(
                read_id=f"r{i}", read_length=n, read_start=0, read_end=n,
                strand="-" if reverse and i % 2 else "+", target_id="T",
                target_length=n,
                target_start=0, target_end=n, n_matches=n - len(err_pos),
                alignment_block_length=n, mapping_quality=60,
                cs="".join(parts)))
            fh.write(f"@r{i}\n{seq}\n+\n"
                     + "".join(chr(v + 33) for v in q) + "\n")
    paf = tmp_path / "r.paf"
    write_paf(recs, str(paf))
    return str(fastq), str(paf)


def test_calibrate_file_entry(tmp_path):
    """End-to-end: fastq + paf -> fit (synthetic, perfect calibration)."""
    from xna_basecaller_tpu_torch.tools.calibrate_qscores import calibrate

    fastq, paf = _fixture(tmp_path)
    fit = calibrate(fastq, paf, min_count=20, log=lambda *a: None)
    # roughly calibrated input -> alpha near 1
    assert 0.5 < fit["alpha"] < 2.0


@pytest.mark.parametrize("reverse", [False, True])
def test_calibrate_equals_jax(tmp_path, reverse):
    """The same FASTQ and PAF through both packages' ``calibrate`` with a
    model directory: the fit dict (alpha, beta, table, scale, bias) and
    the rewritten config.toml equal JAX's, and so does the log (the model
    directory's name aside)."""
    from xna_basecaller_tpu.core import config as jconfig
    from xna_basecaller_tpu.core.config import ModelConfig as JModelConfig
    from xna_basecaller_tpu.tools import calibrate_qscores as jcal
    from xna_basecaller_tpu_torch.tools import calibrate_qscores as tcal

    fastq, paf = _fixture(tmp_path, reverse)
    out = {}
    for name, mod in (("jax", jcal), ("port", tcal)):
        d = tmp_path / name
        d.mkdir()
        jconfig.save(JModelConfig(), str(d))
        lines = []
        fit = mod.calibrate(fastq, paf, model_dir=str(d), min_count=20,
                            log=lines.append)
        lines = [ln.replace(str(d), "DIR") for ln in lines]
        out[name] = (fit, lines, (d / "config.toml").read_text())
    assert out["port"] == out["jax"]
    assert out["port"][0]["scale"] != JModelConfig().qscore.scale


def test_calibrate_runs_as_a_module(tmp_path):
    """``python -m xna_basecaller_tpu_torch.tools.calibrate_qscores FASTQ
    PAF --update-model DIR --min-count 20`` rewrites DIR's qscore scale."""
    import os
    import subprocess
    import sys

    from xna_basecaller_tpu_torch.core import config as config_lib
    from xna_basecaller_tpu_torch.core.config import ModelConfig

    fastq, paf = _fixture(tmp_path)
    d = tmp_path / "model"
    d.mkdir()
    config_lib.save(ModelConfig(), str(d))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "xna_basecaller_tpu_torch.tools."
         "calibrate_qscores", fastq, paf, "--update-model", str(d),
         "--min-count", "20"], capture_output=True, text=True, cwd=root,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "alpha=" in proc.stdout and "updated" in proc.stdout
    assert config_lib.load(str(d)).qscore.scale != ModelConfig().qscore.scale
