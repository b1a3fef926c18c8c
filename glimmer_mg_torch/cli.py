"""Command-line entry points of the PyTorch port.

Usage: python -m glimmer_mg_torch.cli <command> [options]

Commands mirror the reference tool surface (glimmer3, build-icm, long-orfs,
extract, ...) with the same file formats, so the reference's pipelines can be
driven by this framework interchangeably. They are the counterparts of
``glimmer_mg_tpu.cli``'s, with the same arguments and output bytes; the
commands that run on a device (glimmer-mg, classify, glimmer-mg-pipeline)
take ``--device`` (default ``cuda``, an error where CUDA is absent), and
glimmer-mg and glimmer-mg-pipeline the prediction route ``--engine``
(device, native, host) and ``--precompute`` (device, host). ``--mesh
DATA,MODEL`` shards classify and the pipeline's classification and
clustering over a (data, model) mesh of ranks on ``torch.distributed``
(``parallel.mesh``): one process per rank, the world described by a
launcher (``torchrun``) or, for classify, by ``--coordinator``,
``--num_procs`` and ``--proc_id`` given together.
"""

from __future__ import annotations

import argparse
import sys


def _stops_by_code(parser, code):
    """Set_Stop_Codons_By_Code (gene.cc:1560): stop set for a Genbank
    translation table, with the reference's error message on a bad code."""
    from .io.genome_data import STOP_CODONS_BY_CODE

    try:
        return list(STOP_CODONS_BY_CODE[code])
    except KeyError:
        parser.error(f"ERROR:  Bad translation table = {code}")


def _add_device(p, route=False):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; cpu runs the "
                        "kernels' plain PyTorch versions)")
    if route:
        from .engine.glimmer_mg import ENGINES, PRECOMPUTES

        p.add_argument("--engine", default="device", choices=ENGINES,
                       help="prediction route: the device DP, the native "
                            "C++ engine, or the exact host engine")
        p.add_argument("--precompute", default="device", choices=PRECOMPUTES,
                       help="the native engine's six-frame scores: the "
                            "kernel on --device, or the engine's own walk")


def _device(p, name):
    """The checked torch device, or a parser error naming the cause."""
    from .engine.glimmer_mg import _check_device

    try:
        return _check_device(name)
    except (RuntimeError, ValueError) as exc:
        p.error(f"--device {name}: {exc}")


def _mesh(p, spec, device, multihost=(None, None, None)):
    """Join the world of ranks and build the ``--mesh DATA,MODEL`` mesh on
    it; a parser error names what is wrong. ``multihost`` is (coordinator,
    num_procs, proc_id), all given or none; with none, the world is the
    one a launcher describes in the environment. Nothing joins a world
    without ``spec`` or ``multihost``. Returns (mesh or None, this rank's
    device)."""
    from .parallel import mesh as pmesh

    coordinator, num_procs, proc_id = multihost
    if any(v is not None for v in multihost):
        if coordinator is None or num_procs is None or proc_id is None:
            p.error("--coordinator, --num_procs and --proc_id must be given "
                    "together")
        if not 0 <= proc_id < num_procs:
            p.error("--proc_id must satisfy 0 <= proc_id < num_procs")
    elif spec is None:
        return None, device
    if spec is not None:
        try:
            data, model = (int(x) for x in spec.split(","))
        except ValueError:
            p.error(f"--mesh {spec}: expected DATA,MODEL")
    if not pmesh.init_distributed(*multihost, device=device):
        if spec is None:  # --num_procs 1: one process, as without the flags
            return None, device
        p.error(f"--mesh {spec} needs a world of ranks: run under a launcher "
                "(torchrun) or give --coordinator, --num_procs and "
                "--proc_id")
    if spec is None:
        return None, pmesh.rank_device(device)
    try:
        mesh = pmesh.make_mesh(data, model, device=device)
    except ValueError as exc:
        pmesh.destroy()
        p.error(f"--mesh {spec}: {exc}")
    return mesh, pmesh.rank_device(device)


def cmd_build_icm(argv):
    p = argparse.ArgumentParser(prog="build-icm")
    p.add_argument("output")
    p.add_argument("-d", "--depth", type=int, default=7)
    p.add_argument("-p", "--period", type=int, default=3)
    p.add_argument("-w", "--width", type=int, default=12)
    p.add_argument("-r", "--reverse", action="store_true")
    p.add_argument("-F", "--no_stops", action="store_true")
    p.add_argument("--input", default="-", help="multi-FASTA (default stdin)")
    a = p.parse_args(argv)

    from .io.fasta import read_fasta
    from .models import dna, icm as icm_mod, icm_train

    src = sys.stdin if a.input == "-" else open(a.input)
    import io as _io, tempfile, os

    text = src.read()
    recs = []
    header = None
    chunks = []
    for line in text.splitlines():
        if line.startswith(">"):
            if header is not None:
                recs.append("".join(chunks))
            header = line
            chunks = []
        elif header is not None:
            chunks.append("".join(line.split()))
    if header is not None:
        recs.append("".join(chunks))

    strings = icm_train.prepare_training_strings(
        recs, reverse=a.reverse, skip_in_frame_stops=a.no_stops
    )
    m = icm_train.train_icm(
        [dna.encode(s) for s in strings],
        model_len=a.width,
        depth=a.depth,
        periodicity=a.period,
    )
    icm_mod.write_icm(m, a.output)


def cmd_glimmer3(argv):
    p = argparse.ArgumentParser(prog="glimmer3")
    p.add_argument("sequence_file")
    p.add_argument("tag")
    p.add_argument("-m", "--icm", required=True)
    p.add_argument("-u", "--fudge", type=float, default=None)
    p.add_argument("-g", "--gene_len", type=int, default=75)
    p.add_argument("-o", "--max_olap", type=int, default=50)
    p.add_argument("-C", "--gc_percent", type=float, default=None)
    p.add_argument("-b", "--rbs_pwm", default=None)
    p.add_argument("-f", "--features", default=None,
                   help="features file (correct semantics, unlike the "
                        "reference glimmer3 whose -f toggles first-codon)")
    p.add_argument("--first_codon", action="store_true",
                   help="use first start codon (reference -f behavior)")
    p.add_argument("-A", "--start_codons", default=None)
    p.add_argument("-Z", "--stop_codons", default=None)
    p.add_argument("-z", "--trans_table", type=int, default=None,
                   help="Genbank translation table for stop codons")
    p.add_argument("-i", "--ignore", default=None, help="ignore-regions file")
    p.add_argument("-L", "--orf_coords", default=None, help="score ORFs at coords")
    p.add_argument("-M", "--separate_genes", action="store_true")
    p.add_argument("-X", "--extend", action="store_true",
                   help="allow orfs truncated by the sequence ends")
    p.add_argument("-q", "--ignore_score_len", type=int, default=None,
                   help="ignore the independent score on orfs longer than this")
    p.add_argument("-l", "--linear", action="store_true",
                   help="linear genome (the reference default; kept for "
                        "command-line parity)")
    p.add_argument("--detail", default=None, metavar="FILE",
                   help="write the per-ORF diagnostic score table (the "
                        "reference's .detail output, glimmer3.cc:1527-1542, "
                        "which no reference flag ever enables)")
    # accepted for parity; these only affect the reference's detail log,
    # which no flag ever writes (glimmer3.cc:1108,1260; Threshold_Score
    # filter is commented out at glimmer3.cc:1472-1487)
    p.add_argument("-P", "--start_probs", default=None, help=argparse.SUPPRESS)
    p.add_argument("-E", "--entropy", default=None, help=argparse.SUPPRESS)
    p.add_argument("-t", "--threshold", type=int, default=None,
                   help=argparse.SUPPRESS)
    p.add_argument("-n", "--no_indep", action="store_true",
                   help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.trans_table is not None and a.stop_codons is None:
        a.stop_codons = ",".join(_stops_by_code(p, a.trans_table))

    from .io.fasta import read_fasta
    from .models import icm as icm_mod, features as feat
    from .engine import glimmer3 as g3
    from .engine.orfs import parse_ignore_regions

    recs = list(read_fasta(a.sequence_file))
    m = icm_mod.read_icm(a.icm)

    if a.orf_coords or a.separate_genes:
        from .engine.glimmer3 import Models, gc_fraction, set_ignore_score_len
        from .engine.orfs import CodonPatterns
        from .models import dna as dna_mod, icm as _icm

        pat = CodonPatterns.make(
            a.start_codons.split(",") if a.start_codons else None,
            a.stop_codons.split(",") if a.stop_codons else None,
        )
        gc = (a.gc_percent / 100.0 if a.gc_percent is not None
              else gc_fraction([s for _, s in recs]))
        indep = _icm.build_indep_wo_stops(gc, pat.stop_codons)
        models = Models(gene_icm=m, indep_model=indep, patterns=pat,
                        indep_gc_frac=gc)
        with open(a.tag + ".predict", "w") as fh:
            if a.separate_genes:
                fh.write(g3.score_separate_input(
                    models, [(h, s.lower()) for h, s in recs]))
            else:
                _, seq = recs[0]
                fh.write(g3.score_orflist(models, dna_mod.encode(seq),
                                          open(a.orf_coords).read()))
        return
    rbs = None
    if a.rbs_pwm:
        rbs = feat.PWM.read(a.rbs_pwm)
        rbs.counts_to_prob()
        rbs.probs_to_logs()
    feature_models = None
    if a.features:
        from .io.features_file import parse_features

        feature_models = parse_features(a.features, min_gene_len=a.gene_len,
                                        max_olap_bases=a.max_olap)
    import contextlib

    detail_cm = (open(a.detail, "w") if a.detail
                 else contextlib.nullcontext(None))
    with detail_cm as detail_fp:
        results = list(
            g3.run_glimmer3(
                recs,
                m,
                detail_fp=detail_fp,
                gc_frac=None if a.gc_percent is None else a.gc_percent / 100.0,
                logodds_fudge=a.fudge,
                min_gene_len=a.gene_len,
                max_olap_bases=a.max_olap,
                use_first_start_codon=a.first_codon,
                allow_truncated_orfs=a.extend,
                ignore_score_len=a.ignore_score_len,
                start_codons=a.start_codons.split(",") if a.start_codons else None,
                stop_codons=a.stop_codons.split(",") if a.stop_codons else None,
                rbs_pwm=rbs,
                feature_models=feature_models,
                ignore_regions=(
                    parse_ignore_regions(open(a.ignore).read())
                    if a.ignore else None
                ),
            )
        )
    with open(a.tag + ".predict", "w") as fh:
        fh.write(g3.format_predict(results))


def cmd_glimmer_mg(argv):
    p = argparse.ArgumentParser(prog="glimmer-mg")
    p.add_argument("sequence_file")
    p.add_argument("tag")
    p.add_argument("-m", "--icm", default=None)
    p.add_argument("-c", "--classes", default=None, help="classification file")
    p.add_argument("-u", "--fudge", type=float, default=None)
    p.add_argument("-g", "--gene_len", type=int, default=75)
    p.add_argument("-o", "--max_olap", type=int, default=50)
    p.add_argument("-b", "--rbs_pwm", default=None)
    p.add_argument("-f", "--features", default=None)
    p.add_argument("-i", "--indel", action="store_true")
    p.add_argument("-s", "--sub", action="store_true")
    p.add_argument("-q", "--quality", default=None)
    p.add_argument("-r", "--circular", action="store_true")
    p.add_argument("-z", "--trans_table", type=int, default=None,
                   help="Genbank translation table for stop codons")
    p.add_argument("-Z", "--stop_codons", default=None)
    p.add_argument("--genome_data", default=None,
                   help="genomeData directory for -c mode (the reference "
                        "compiles this path in; glimmer-mg.cc:147)")
    p.add_argument("--num_procs", type=int, default=1,
                   help="read-shard the predict stage over N processes "
                        "(-c mode): this process handles a contiguous "
                        "slice of the emission order and writes "
                        "<tag>.predict.part<proc_id>; concatenating the "
                        "parts is byte-equal to a single-process run "
                        "(reference combine_seq merge, phymm_par.py:283)")
    p.add_argument("--proc_id", type=int, default=0)
    _add_device(p, route=True)
    a = p.parse_args(argv)
    device = _device(p, a.device)
    route = dict(device=device, engine=a.engine, precompute=a.precompute)

    from .io.fasta import read_fasta, read_qual
    from .models import icm as icm_mod, features as feat
    from .engine import glimmer_mg as mg

    stop_codons = a.stop_codons.split(",") if a.stop_codons else None
    if a.trans_table is not None and stop_codons is None:
        stop_codons = _stops_by_code(p, a.trans_table)
    recs = list(read_fasta(a.sequence_file))
    rbs = None
    if a.rbs_pwm:
        rbs = feat.PWM.read(a.rbs_pwm)
        rbs.counts_to_prob()
        rbs.probs_to_logs()
    quals = None
    if a.quality:
        quals = {h.split()[0]: q for h, q in read_qual(a.quality)}

    if a.classes is not None:
        from .io.genome_data import GenomeData, parse_classes

        if a.genome_data is None:
            p.error("-c requires --genome_data (the reference hardcodes "
                    "ICM_dir at compile time)")
        gd = GenomeData(a.genome_data)
        cls_map = parse_classes(a.classes)
        if a.num_procs < 1 or not 0 <= a.proc_id < a.num_procs:
            # an out-of-range proc_id would silently write an empty
            # .predict.partN, dropping reads at merge time
            p.error("--proc_id must satisfy 0 <= proc_id < num_procs")
        if a.num_procs > 1:
            # contiguous slice of the deterministic emission order; the
            # reads in this slice are predicted independently of every
            # other process (the predict stage has no cross-read state)
            order = mg.classes_emission_order(gd, cls_map)
            present = {h.split()[0] for h, _ in recs}
            order = [pr for pr in order if pr in present]
            per = -(-len(order) // a.num_procs)
            mine = set(order[a.proc_id * per : (a.proc_id + 1) * per])
            recs = [r for r in recs if r[0].split()[0] in mine]
        results = list(
            mg.run_glimmer_mg_classes(
                recs,
                gd,
                cls_map,
                qualities=quals,
                user_icm=icm_mod.read_icm(a.icm) if a.icm else None,
                features_path=a.features,
                user_rbs_pwm=rbs,
                logodds_fudge=a.fudge,
                min_gene_len=a.gene_len,
                max_olap_bases=a.max_olap,
                allow_indels=a.indel,
                allow_subs=a.sub,
                circular=a.circular,
                user_stop_codons=stop_codons,
                **route,
            )
        )
    else:
        if a.icm is None:
            p.error("either -m <icm> or -c <classes> is required")
        results = list(
            mg.run_glimmer_mg(
                recs,
                icm_mod.read_icm(a.icm),
                qualities=quals,
                features_path=a.features,
                rbs_pwm=rbs,
                logodds_fudge=a.fudge,
                min_gene_len=a.gene_len,
                max_olap_bases=a.max_olap,
                allow_indels=a.indel,
                allow_subs=a.sub,
                circular=a.circular,
                stop_codons=stop_codons,
                **route,
            )
        )
    suffix = (".predict.part%d" % a.proc_id) if a.num_procs > 1 else ".predict"
    with open(a.tag + suffix, "w") as fh:
        fh.write(mg.format_predict_mg(results))


def cmd_long_orfs(argv):
    p = argparse.ArgumentParser(prog="long-orfs")
    p.add_argument("sequence_file")
    p.add_argument("output", help="output file or - for stdout")
    p.add_argument("-t", "--cutoff", type=float, default=None,
                   help="entropy distance filter cutoff")
    p.add_argument("-g", "--gene_len", type=int, default=90)
    p.add_argument("-o", "--max_olap", type=int, default=30)
    p.add_argument("-f", "--fixed", action="store_true")
    p.add_argument("-L", "--length_opt", action="store_true",
                   help="optimize total bases instead of count")
    p.add_argument("-l", "--linear", action="store_true")
    p.add_argument("-n", "--no_header", action="store_true")
    p.add_argument("-i", "--ignore", default=None, help="ignore-regions file")
    p.add_argument("-w", "--without_stops", action="store_true",
                   help="exclude the stop codon from output coordinates")
    p.add_argument("-E", "--entropy", default=None,
                   help="entropy profile file (pos/neg, 20 rows)")
    p.add_argument("-A", "--start_codons", default=None)
    p.add_argument("-Z", "--stop_codons", default=None)
    p.add_argument("-z", "--trans_table", type=int, default=None,
                   help="Genbank translation table for stop codons")
    a = p.parse_args(argv)

    from .engine.orfs import parse_ignore_regions
    from .io.fasta import read_fasta
    from .pipeline.long_orfs import read_entropy_profiles, run_long_orfs

    stop_codons = a.stop_codons.split(",") if a.stop_codons else None
    xlate_code = 0
    if a.trans_table is not None:
        stop_codons = _stops_by_code(p, a.trans_table)
        xlate_code = a.trans_table
    _, seq = next(iter(read_fasta(a.sequence_file)))
    lines, final_len = run_long_orfs(
        seq,
        min_gene_len=a.gene_len,
        max_olap=a.max_olap,
        circular=not a.linear,
        fixed_min_len=a.fixed,
        optimize_total=a.length_opt,
        entropy_cutoff=a.cutoff,
        start_codons=a.start_codons.split(",") if a.start_codons else None,
        stop_codons=stop_codons,
        xlate_code=xlate_code,
        ignore_regions=(parse_ignore_regions(open(a.ignore).read())
                        if a.ignore else None),
        without_stops=a.without_stops,
        entropy_profiles=(read_entropy_profiles(a.entropy)
                          if a.entropy else None),
    )
    out = sys.stdout if a.output == "-" else open(a.output, "w")
    if not a.no_header:
        out.write("\nPutative Genes:\n")
    out.write("\n".join(lines) + "\n")
    if a.output != "-":
        out.close()


def cmd_extract(argv):
    p = argparse.ArgumentParser(prog="extract")
    p.add_argument("sequence_file")
    p.add_argument("coords", help="coordinate list file or - for stdin")
    p.add_argument("-t", "--nostop", action="store_true")
    p.add_argument("-s", "--nostart", action="store_true")
    p.add_argument("-w", "--nowrap", action="store_true")
    p.add_argument("-l", "--minlen", type=int, default=0)
    p.add_argument("-d", "--dir", action="store_true")
    a = p.parse_args(argv)

    from .io.fasta import read_fasta, write_fasta
    from .pipeline.extract import extract

    _, seq = next(iter(read_fasta(a.sequence_file)))
    coords = sys.stdin.read() if a.coords == "-" else open(a.coords).read()
    recs = extract(
        seq, coords,
        is_circular=not a.nowrap, min_len=a.minlen,
        skip_start=a.nostart, skip_stop=a.nostop, use_direction=a.dir,
    )
    write_fasta(sys.stdout, recs, width=60)


def cmd_train_features(argv):
    p = argparse.ArgumentParser(prog="train-features")
    p.add_argument("--predict", required=True)
    p.add_argument("--seq", required=True)
    p.add_argument("-l", "--min_length", type=int, default=75)
    p.add_argument("-o", "--max_overlap", type=int, default=50)
    p.add_argument("--min_icm", type=int, default=0)
    p.add_argument("-z", "--mycoplas", action="store_true")
    a = p.parse_args(argv)

    import os

    from .io.fasta import read_fasta_dict
    from .pipeline.train_features import train_features

    seqs = read_fasta_dict(a.seq)
    out_prefix = os.path.splitext(a.predict)[0]
    train_features(
        open(a.predict).read(), seqs, out_prefix,
        min_length=a.min_length, max_overlap=a.max_overlap,
        min_icm_bp=a.min_icm, mycoplasma=a.mycoplas,
    )


def cmd_g3_iterated(argv):
    p = argparse.ArgumentParser(prog="g3-iterated")
    p.add_argument("genome")
    p.add_argument("tag")
    p.add_argument("--no-quirk", action="store_true",
                   help="apply features files in runs 2-3 (the documented "
                        "intent) instead of the reference binary's behavior")
    p.add_argument("--time", action="store_true",
                   help="write time_<tag>_<step>.txt files")
    p.add_argument("-v", "--verbose", action="count", default=0)
    a = p.parse_args(argv)

    from .pipeline.g3_iterated import run_g3_iterated
    from .utils.observe import set_verbose

    set_verbose(a.verbose)
    run_g3_iterated(a.genome, a.tag, quirk_compat=not a.no_quirk,
                    time_files=a.time)


def cmd_anomaly(argv):
    p = argparse.ArgumentParser(prog="anomaly")
    p.add_argument("sequence_file")
    p.add_argument("coords")
    p.add_argument("-s", "--no_check_start", action="store_true")
    p.add_argument("-p", "--check_previous_stop", action="store_true")
    a = p.parse_args(argv)
    from .io.fasta import read_fasta
    from .pipeline.util_tools import anomaly

    _, seq = next(iter(read_fasta(a.sequence_file)))
    lines, ok_ct, prob_ct = anomaly(
        seq, open(a.coords).read(),
        check_start=not a.no_check_start,
        check_previous_stop=a.check_previous_stop,
    )
    for line in lines:
        print(line)
    print("     OK orfs = %7d" % ok_ct, file=sys.stderr)
    print("Problem orfs = %7d" % prob_ct, file=sys.stderr)


def cmd_uncovered(argv):
    p = argparse.ArgumentParser(prog="uncovered")
    p.add_argument("sequence_file")
    p.add_argument("coords")
    p.add_argument("-l", "--minlen", type=int, default=0)
    p.add_argument("-t", "--nostop", action="store_true")
    p.add_argument("-s", "--nostart", action="store_true")
    p.add_argument("-w", "--nowrap", action="store_true")
    a = p.parse_args(argv)
    from .io.fasta import read_fasta, write_fasta
    from .pipeline.util_tools import uncovered

    _, seq = next(iter(read_fasta(a.sequence_file)))
    coords = sys.stdin.read() if a.coords == "-" else open(a.coords).read()
    write_fasta(sys.stdout, uncovered(
        seq, coords, is_circular=not a.nowrap, min_len=a.minlen,
        skip_start=a.nostart, skip_stop=a.nostop), width=60)


def cmd_window_acgt(argv):
    p = argparse.ArgumentParser(prog="window-acgt")
    p.add_argument("window_len", type=int)
    p.add_argument("window_skip", type=int)
    p.add_argument("-p", "--percent", action="store_true")
    a = p.parse_args(argv)
    from .pipeline.util_tools import window_acgt

    sys.stdout.write(window_acgt(sys.stdin.read(), a.window_len, a.window_skip,
                                 percents=a.percent))


def cmd_start_codon_distrib(argv):
    p = argparse.ArgumentParser(prog="start-codon-distrib")
    p.add_argument("sequence_file")
    p.add_argument("coords")
    p.add_argument("-3", "--comma3", dest="comma3", action="store_true")
    p.add_argument("-w", "--nowrap", action="store_true")
    a = p.parse_args(argv)
    from .io.fasta import read_fasta
    from .pipeline.util_tools import start_codon_distrib

    _, seq = next(iter(read_fasta(a.sequence_file)))
    coords = sys.stdin.read() if a.coords == "-" else open(a.coords).read()
    sys.stdout.write(start_codon_distrib(seq, coords, comma3=a.comma3,
                                         is_circular=not a.nowrap))


def cmd_multi_extract(argv):
    p = argparse.ArgumentParser(prog="multi-extract")
    p.add_argument("sequence_file")
    p.add_argument("coords")
    p.add_argument("-t", "--nostop", action="store_true")
    p.add_argument("-s", "--nostart", action="store_true")
    p.add_argument("-w", "--nowrap", action="store_true")
    p.add_argument("-l", "--minlen", type=int, default=0)
    p.add_argument("-d", "--dir", action="store_true")
    a = p.parse_args(argv)
    from .io.fasta import read_fasta, write_fasta
    from .pipeline.util_tools import multi_extract

    recs = list(read_fasta(a.sequence_file))
    coords = sys.stdin.read() if a.coords == "-" else open(a.coords).read()
    write_fasta(sys.stdout, multi_extract(
        recs, coords, is_circular=not a.nowrap, min_len=a.minlen,
        skip_start=a.nostart, skip_stop=a.nostop, use_direction=a.dir),
        width=60)


def cmd_entropy_profile(argv):
    p = argparse.ArgumentParser(prog="entropy-profile")
    p.add_argument("-l", "--minlen", type=int, default=0)
    a = p.parse_args(argv)
    import io as _io

    from .io.fasta import read_fasta
    from .pipeline.util_tools import entropy_profile

    text = sys.stdin.read()
    recs = []
    header = None
    chunks: list[str] = []
    for line in text.splitlines():
        if line.startswith(">"):
            if header is not None:
                recs.append((header, "".join(chunks)))
            header = line[1:]
            chunks = []
        elif header is not None:
            chunks.append("".join(line.split()))
    if header is not None:
        recs.append((header, "".join(chunks)))
    sys.stdout.write(entropy_profile(recs, min_len=a.minlen))


def cmd_classify(argv):
    p = argparse.ArgumentParser(
        prog="classify",
        description="Phymm-equivalent read classification on the GPU bank",
    )
    p.add_argument("sequence_file")
    p.add_argument("icm_dir")
    p.add_argument("-o", "--out_dir", default=".")
    p.add_argument("--batch", type=int, default=512,
                   help="reads a bank-walk launch (with --mesh, of a "
                        "rank's own reads)")
    p.add_argument("--mesh", metavar="DATA,MODEL",
                   help="shard over a (data, model) device mesh, e.g. 4,2 "
                        "(the reference phymm_par.py -p fan-out)")
    p.add_argument("--coordinator", metavar="HOST:PORT",
                   help="multi-host: rank 0's rendezvous address")
    p.add_argument("--num_procs", type=int, help="multi-host: process count")
    p.add_argument("--proc_id", type=int, help="multi-host: this process id")
    _add_device(p)
    a = p.parse_args(argv)
    device = _device(p, a.device)
    mesh, device = _mesh(p, a.mesh, device,
                         (a.coordinator, a.num_procs, a.proc_id))
    from .parallel import mesh as pmesh
    from .parallel.phymm import classify_file

    try:
        classify_file(a.sequence_file, a.icm_dir, out_dir=a.out_dir,
                      batch=a.batch, device=device, mesh=mesh)
    finally:
        pmesh.destroy()


def cmd_glimmer_mg_pipeline(argv):
    p = argparse.ArgumentParser(
        prog="glimmer-mg-pipeline",
        description="Full metagenomics pipeline (classify/cluster/repredict)",
    )
    p.add_argument("sequence_file")
    p.add_argument("icm_dir")
    p.add_argument("-o", "--out", default=None)
    p.add_argument("--top_hits", type=int, default=3)
    p.add_argument("--iterate", type=int, default=1)
    p.add_argument("--filter_t", type=float, default=1.0)
    p.add_argument("--all_features", action="store_true")
    p.add_argument("-i", "--indel", action="store_true")
    p.add_argument("-s", "--sub", action="store_true")
    p.add_argument("-q", "--quality", default=None)
    p.add_argument("-u", "--fudge", type=float, default=None)
    p.add_argument("--workdir", default=".")
    p.add_argument("--raw", action="store_true", help="raw Phymm output exists")
    p.add_argument("--cls", action="store_true", help="class file exists")
    p.add_argument("--clust", action="store_true", help="clusters exist")
    p.add_argument("--time", action="store_true",
                   help="write time_<out>_<stage>.txt files (reference --time)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace, with the program's "
                   "spans from every thread, to DIR")
    p.add_argument("--mesh", metavar="DATA,MODEL", default=None,
                   help="shard classification + EM over a (data, model) mesh")
    p.add_argument("-v", "--verbose", action="count", default=0,
                   help="stage timing/throughput lines to stderr")
    _add_device(p, route=True)
    a = p.parse_args(argv)
    device = _device(p, a.device)
    mesh, device = _mesh(p, a.mesh, device)
    from .parallel import mesh as pmesh
    from .pipeline.glimmer_mg_pipe import run_pipeline
    from .utils.observe import StageTimers, set_verbose

    set_verbose(a.verbose)
    timers = StageTimers()
    try:
        final = run_pipeline(
            a.sequence_file, a.icm_dir, a.out,
            top_hits=a.top_hits, iterate=a.iterate, filter_t=a.filter_t,
            all_features=a.all_features, indels=a.indel, subs=a.sub,
            quality_file=a.quality, fudge=a.fudge, workdir=a.workdir,
            raw_done=a.raw, class_done=a.cls, clust_done=a.clust,
            time_files=a.time, timers=timers, profile_dir=a.profile,
            device=device, engine=a.engine, precompute=a.precompute,
            mesh=mesh,
        )
    finally:
        pmesh.destroy()
    if a.verbose:
        print(timers.report(), file=sys.stderr)
    print(final)


COMMANDS = {
    "build-icm": cmd_build_icm,
    "glimmer3": cmd_glimmer3,
    "glimmer-mg": cmd_glimmer_mg,
    "long-orfs": cmd_long_orfs,
    "extract": cmd_extract,
    "train-features": cmd_train_features,
    "g3-iterated": cmd_g3_iterated,
    "anomaly": cmd_anomaly,
    "uncovered": cmd_uncovered,
    "window-acgt": cmd_window_acgt,
    "start-codon-distrib": cmd_start_codon_distrib,
    "multi-extract": cmd_multi_extract,
    "entropy-profile": cmd_entropy_profile,
    "classify": cmd_classify,
    "glimmer-mg-pipeline": cmd_glimmer_mg_pipeline,
    "build-fixed": None,  # replaced below
    "score-fixed": None,
}


def cmd_build_fixed(argv):
    p = argparse.ArgumentParser(prog="build-fixed")
    p.add_argument("output", nargs="?", default="-")
    p.add_argument("-d", "--depth", type=int, default=7)
    p.add_argument("-s", "--special", type=int, default=-1)
    p.add_argument("-p", "--permutation", default=None)
    a = p.parse_args(argv)
    from .models import dna, fixed_icm

    recs = []
    header = None
    chunks: list[str] = []
    for line in sys.stdin.read().splitlines():
        if line.startswith(">"):
            if header is not None:
                recs.append("".join(chunks))
            header = line
            chunks = []
        elif header is not None:
            chunks.append("".join(line.split()))
    if header is not None:
        recs.append("".join(chunks))
    perm = [int(x) for x in a.permutation.split(",")] if a.permutation else None
    fm = fixed_icm.train_fixed_icm(
        [dna.encode(s.lower()) for s in recs], max_depth=a.depth,
        special_position=a.special, permutation=perm,
    )
    out = "/dev/stdout" if a.output == "-" else a.output
    fixed_icm.write_fixed_icm(fm, out)


def cmd_score_fixed(argv):
    p = argparse.ArgumentParser(prog="score-fixed")
    p.add_argument("pos_model")
    p.add_argument("neg_model", nargs="?", default=None)
    p.add_argument("-N", "--null_neg", action="store_true")
    p.add_argument("-I", "--icm_neg", action="store_true")
    p.add_argument("-s", "--simple", action="store_true")
    a = p.parse_args(argv)
    from .models import dna, fixed_icm, icm as icm_mod

    fm = fixed_icm.read_fixed_icm(a.pos_model)
    neg_icm = neg_fixed = None
    if not a.null_neg:
        if a.icm_neg:
            neg_icm = icm_mod.read_icm(a.neg_model)
        else:
            neg_fixed = fixed_icm.read_fixed_icm(a.neg_model)
    num = 0
    header = None
    chunks: list[str] = []

    def emit(s):
        nonlocal num
        num += 1
        idx = dna.encode(s.lower())
        ps = fm.score_window(idx)
        if a.null_neg:
            ns = 0.0
        elif neg_icm is not None:
            ns = icm_mod.score_string(neg_icm, idx, 1)
        else:
            ns = neg_fixed.score_window(idx)
        ln = len(s)
        if a.simple:
            sys.stdout.write("%6d %3d\n" % (num - 1, 1 if ps >= ns else -1))
        else:
            sys.stdout.write(
                "%5d:  %10.4f %9.5f   %10.4f %9.5f   %9.5f\n"
                % (num, ps, ps / ln, ns, ns / ln, ps / ln - ns / ln)
            )

    for line in sys.stdin.read().splitlines():
        if line.startswith(">"):
            if header is not None:
                emit("".join(chunks))
            header = line
            chunks = []
        elif header is not None:
            chunks.append("".join(line.split()))
    if header is not None:
        emit("".join(chunks))


def cmd_entropy_score(argv):
    p = argparse.ArgumentParser(prog="entropy-score")
    p.add_argument("sequence_file")
    p.add_argument("coords")
    p.add_argument("-s", "--nostart", action="store_true")
    p.add_argument("-t", "--nostop", action="store_true")
    p.add_argument("-w", "--nowrap", action="store_true")
    p.add_argument("-l", "--minlen", type=int, default=0)
    a = p.parse_args(argv)
    from .io.fasta import read_fasta
    from .pipeline.util_tools import entropy_score

    _, seq = next(iter(read_fasta(a.sequence_file)))
    coords = sys.stdin.read() if a.coords == "-" else open(a.coords).read()
    sys.stdout.write(entropy_score(seq, coords, is_circular=not a.nowrap,
                                   min_len=a.minlen, skip_start=a.nostart,
                                   skip_stop=a.nostop))


def cmd_entropy_fasta(argv):
    argparse.ArgumentParser(prog="entropy-fasta").parse_args(argv)
    from .io.fasta import read_fasta
    from .pipeline.util_tools import entropy_fasta
    import io as _io, tempfile

    recs = []
    header = None
    chunks: list[str] = []
    for line in sys.stdin.read().splitlines():
        if line.startswith(">"):
            if header is not None:
                recs.append((header, "".join(chunks)))
            header = line[1:]
            chunks = []
        elif header is not None:
            chunks.append("".join(line.split()))
    if header is not None:
        recs.append((header, "".join(chunks)))
    sys.stdout.write(entropy_fasta(recs))


COMMANDS["build-fixed"] = cmd_build_fixed
COMMANDS["score-fixed"] = cmd_score_fixed
COMMANDS["entropy-score"] = cmd_entropy_score
COMMANDS["entropy-fasta"] = cmd_entropy_fasta


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in COMMANDS:
        print(f"usage: glimmer_mg_torch <{'|'.join(COMMANDS)}> [options]",
              file=sys.stderr)
        return 2
    return COMMANDS[argv[0]](argv[1:]) or 0


if __name__ == "__main__":
    sys.exit(main())
