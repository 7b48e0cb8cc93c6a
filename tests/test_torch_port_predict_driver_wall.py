"""``python -m ppde_tpu_torch.scripts.predict_driver_wall``: the evidence
drivers' predicted wall seconds from chip_smoke.py's saved results, on a
results file made up of round numbers whose sums are written out here."""
import json

import pytest

from ppde_tpu_torch.scripts import predict_driver_wall as pdw

START = 5.0
# 100 steps at 10 steps/s in 12 s: 2 s of set-up and tail
RUN = {"steps": 100, "steps_per_sec": 10.0, "main_s": 12.0}


def results():
    """A whole run's results in chip_smoke.json's layout, every run RUN."""
    cells = [{"expert": e, "steps_per_sec": sps, "msa_s_scoring_s": 3.0}
             for e, sps in (("potts+transformer-S", 20.0),
                            ("transformer-S", 25.0)) for _ in range(4)]
    flags = ("GFP_PPDE-refrev", "GFP_CMAES", "GFP_PPDE-pottsonly",
             "GFP_PPDE-suponly", "UBE4B_PPDE-PT-suponly",
             "UBE4B_PPDE-suponly-exact")
    ev = {"process_start_s": START,
          "family_cells": {"cells": cells, "outside_first_cell_s": 4.0,
                           "outside_later_cells_mean_s": 1.0},
          "finetune": RUN,
          "evidence_flags": [{"run": f + "_s1234567", **RUN} for f in flags],
          "qc": {"fit_potts": {"main_s": 30.0},
                 "select_lambda": {"main_s": 1.0},
                 "calibrate_oracle_scale": [{"main_s": 2.0},
                                            {"main_s": 4.0}],
                 "sample_potts_msa": {"main_s": 10.0, "gibbs_s": 8.0,
                                      "sweeps_per_sec": 10.0}},
          "scorer_mnist": {"mnist": [{"run": "PAS", **RUN},
                                     {"run": "PPDE-PT", **RUN}],
                           "scorer_eval": {"random": {"main_s": 6.0},
                                           "trained": {"main_s": 8.0}},
                           "mnist_summary": {"main_s": 3.0}}}
    return {"evidence": ev,
            "cli": [{"run": k, **RUN} for k in ("SA", "Random",
                                                "MALA-approx")],
            "mnist": [{"run": k, **RUN} for k in ("SA", "MALA-approx",
                                                  "CMAES")],
            "training": {"finetune_msa_S": RUN},
            "large": {s: {"finetune": RUN, "cell": RUN}
                      for s in ("run_r5_150m", "run_r4_650m")}}


def test_predictions_are_the_written_sums():
    res = results()
    got = pdw.predict(res["evidence"], res)
    # 3 fine-tunes of 4,000 steps, one run_cells process, its first cell
    # (set-up 4) then 11 potts+S and 12 S cells (set-up 1), each scored
    family10k = (3 * (START + 2 + 400) + START + (4 + 500 + 3)
                 + 11 * (1 + 500 + 3) + 12 * (1 + 400 + 3))
    assert got["run_r5_family10k.sh"] == pytest.approx(family10k)
    # two fits (a process each) and two calibrations (mean 3 s each)
    assert got["run_r5_ljdecision.sh"] == pytest.approx(
        2 * ((START + 30) + (START + 3)))
    # 3 proteins x (random + trained), a process each
    assert got["run_r4_scorer_eval.sh"] == pytest.approx(
        3 * (START + 6 + START + 8))
    # run_cells' baseline grid in one process (9 x SA, Random, MALA at
    # 10,000 steps, CMA-ES at 1,000), the 150M row, the family queue, the
    # MNIST CMA-ES grid in one process
    baseline = START + 9 * (3 * (2 + 1000) + (2 + 100))
    m150 = (START + 2 + 120) + (START + 2 + 100)
    assert got["run_r5_remaining.sh"] == pytest.approx(
        baseline + m150 + family10k + START + 3 * (2 + 2000))
    parts = ("run_r4_family_cells.sh", "run_r4_evidence.sh proteins",
             "run_r4_evidence.sh mnist", "run_r4_qc_pt.sh qc",
             "run_r4_qc_pt.sh pt")
    m650 = (START + 2 + 80) + (START + 2 + 100)  # 800 and 1,000 steps
    assert got["run_r4_all.sh"] == pytest.approx(
        sum(got[k] for k in parts) + m650)


def test_rest_gives_the_other_phases_of_a_phase_15_file(tmp_path, capsys):
    """A file of phase 15 alone takes phases 7-14 from ``--rest``; the
    rest file's own phase 15 is not read."""
    res = results()
    alone, rest = tmp_path / "alone.json", tmp_path / "rest.json"
    alone.write_text(json.dumps({"evidence": res["evidence"]}))
    other = dict(res, evidence={**res["evidence"], "process_start_s": 99.0})
    rest.write_text(json.dumps(other))
    got = pdw.main(pdw.build_parser().parse_args(
        [str(alone), "--rest", str(rest)]))
    assert got == pdw.predict(res["evidence"], res)
    assert json.loads(capsys.readouterr().out) == got
    whole = tmp_path / "whole.json"
    whole.write_text(json.dumps(res))
    assert pdw.main(pdw.build_parser().parse_args([str(whole)])) == got
