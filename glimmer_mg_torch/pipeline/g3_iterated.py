"""g3-iterated: single-genome iterative training pipeline.

Reference scripts/g3-iterated.py (8 steps): long-orfs -> extract ->
build-icm -r -> glimmer3 (-u -12) -> train_features -> glimmer3 (features +
motif + gicm) -> retrain -> final glimmer3. All steps run in-process through
this framework's components; artifacts use the reference file formats so
runs are resumable/interchangeable with the reference toolchain.

Note on the second/third glimmer3 runs: the reference glimmer3 binary's -f
flag actually toggles Use_First_Start_Codon and drops the features file
(swapped option table, glimmer3.cc:762-845); ``quirk_compat=True``
reproduces that behavior (our parity oracle), ``False`` applies the features
file as g3-iterated intended.
"""

from __future__ import annotations

import os

from ..io.fasta import read_fasta, write_fasta
from ..models import dna, icm as icm_mod, icm_train, features as feat
from . import extract as ex
from . import long_orfs as lo
from . import train_features as tf


def run_g3_iterated(
    genome_file: str,
    tag: str,
    *,
    quirk_compat: bool = True,
    glimmer_opts: dict | None = None,
    verbose: bool = True,
    timers=None,
    time_files: bool = False,
):
    """Run the 8-step pipeline; writes the reference's artifact set.

    ``timers`` (utils.observe.StageTimers) collects per-step wall-clock and
    Mbp/s; ``time_files=True`` writes ``time_<tag>_<step>.txt`` files.
    """
    from ..engine import glimmer3 as g3
    from ..utils.observe import StageTimers

    timers = timers or StageTimers()

    def log(msg):
        if verbose:
            print(msg)

    recs = list(read_fasta(genome_file))
    header, seq = recs[0]
    total_bp = sum(len(s) for _, s in recs)

    # step 1: long orfs
    log("Step 1/8: long-orfs")
    with timers.stage("long-orfs", log=False) as st:
        st.bp = total_bp
        lines, _ = lo.run_long_orfs(seq, entropy_cutoff=1.15)
    with open(f"{tag}.longorfs", "w") as fh:
        fh.write("\n".join(lines) + "\n")

    # step 2: extract training sequences
    log("Step 2/8: extract")
    train_recs = list(ex.extract(seq, "\n".join(lines), skip_stop=True))
    write_fasta(f"{tag}.train", train_recs, width=60)

    # step 3: build ICM
    log("Step 3/8: build-icm")
    with timers.stage("build-icm", log=False) as st:
        strings = icm_train.prepare_training_strings(
            [s for _, s in train_recs], reverse=True
        )
        st.bp = sum(len(s) for s in strings)
        m = icm_train.train_icm([dna.encode(s) for s in strings])
    icm_mod.write_icm(m, f"{tag}.icm")

    # step 4: first glimmer3
    log("Step 4/8: glimmer3 run1")
    with timers.stage("run1", log=False) as st:
        st.items, st.bp = len(recs), total_bp
        res = list(
            g3.run_glimmer3(recs, m, logodds_fudge=-12, **(glimmer_opts or {}))
        )
    with open(f"{tag}.run1.predict", "w") as fh:
        fh.write(g3.format_predict(res))

    def retrain_and_predict(run_in: str, run_out: str):
        predict = open(f"{run_in}.predict").read()
        tf.train_features(predict, dict(recs), run_in)
        gicm = icm_mod.read_icm(f"{run_in}.gicm")
        rbs = feat.PWM.read(f"{run_in}.motif")
        rbs.counts_to_prob()
        rbs.probs_to_logs()
        if quirk_compat:
            res = list(
                g3.run_glimmer3(recs, gicm, use_first_start_codon=True, rbs_pwm=rbs)
            )
        else:
            from ..io.features_file import parse_features

            parsed = parse_features(
                f"{run_in}.features.txt",
                sequence_aa_lengths=[len(s) // 3 for _, s in recs],
            )
            fm = {
                "logodds_length": parsed.logodds_length,
                "logodds_start": parsed.logodds_start,
                "logodds_adj_or": parsed.logodds_adj_or,
                "logodds_adj_dist": parsed.logodds_adj_dist,
                "logodds_prior": parsed.logodds_prior,
            }
            fm = {k: v for k, v in fm.items() if v is not None}
            res = list(g3.run_glimmer3(recs, gicm, rbs_pwm=rbs, feature_models=fm))
        with open(f"{run_out}.predict", "w") as fh:
            fh.write(g3.format_predict(res))

    # steps 5-6: retrain + second glimmer3
    log("Step 5-6/8: retrain + glimmer3 run2")
    with timers.stage("run2", log=False) as st:
        st.items, st.bp = len(recs), total_bp
        retrain_and_predict(f"{tag}.run1", f"{tag}.run2")

    # steps 7-8: retrain + final glimmer3 (reference overwrites run2)
    log("Step 7-8/8: retrain + final glimmer3")
    with timers.stage("run3", log=False) as st:
        st.items, st.bp = len(recs), total_bp
        retrain_and_predict(f"{tag}.run2", f"{tag}.run2")

    if time_files:
        timers.write_time_files(tag)
    if verbose:
        log(timers.report())
    return f"{tag}.run2.predict"
