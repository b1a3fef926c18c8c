# Frozen copy of glimmer_mg_torch/io/genome_data.py at commit ab5a5d3.
"""Phymm-style genome model database (.genomeData layout).

Reference layout (glimmer-mg.cc:147 ICM_dir + Read_Meta_* loaders,
glimmer-mg.cc:998-1421): one directory per strain containing per-replicon
model files keyed by class strings "strain|replicon":

    <dir>/<strain>/<nc>.gicm                  gene ICM
    <dir>/<strain>/<nc>.motif                 RBS PWM counts
    <dir>/<strain>/<nc>.gc.txt                GC fraction
    <dir>/<strain>/<nc>.lengths.{genes,non}.txt
    <dir>/<strain>/<nc>.starts.{genes,non}.txt
    <dir>/<strain>/<nc>.adj_orients.{genes,non}.txt
    <dir>/<strain>/<nc>.adj_dist.{1.1,1.-1,-1.1}.{genes,non}.txt
    <dir>/<strain>/<nc>.gbk                   (optional; transl_table grep)
    <dir>/<strain1>/<nc1>_2/<strain2>/<nc2>.gicm   pairwise "double" ICMs

This module loads those files into the same distributions the predictors
mix per read (caching per class string), and resolves the per-read ICM file
including the double-ICM lookup (Classes_ICM_File, glimmer-mg.cc:473-516).
"""

from __future__ import annotations

import math
import os
import re

import numpy as np

from ..models import features as feat
from . import features_file as ff


STOP_CODONS_BY_CODE = {
    1: ("taa", "tag", "tga"),
    11: ("taa", "tag", "tga"),
    12: ("taa", "tag", "tga"),
    2: ("taa", "tag", "aga", "agg"),
    3: ("taa", "tag"), 4: ("taa", "tag"), 5: ("taa", "tag"),
    9: ("taa", "tag"), 10: ("taa", "tag"), 13: ("taa", "tag"),
    21: ("taa", "tag"),
    6: ("tga",),
    14: ("tag",),
    15: ("taa", "tga"), 16: ("taa", "tga"),
    22: ("taa", "tga", "tca"),
    23: ("taa", "tag", "tga", "tta"),
}


def parse_classes(path) -> dict[str, list[str]]:
    """glimmer-mg.cc:728 Parse_Classes: header -> [class strings]."""
    out = {}
    with open(path) as fh:
        for line in fh:
            toks = line.split()
            if toks:
                out[toks[0]] = toks[1:]
    return out


class GenomeData:
    def __init__(self, icm_dir: str):
        self.icm_dir = icm_dir
        self._cache: dict[tuple, object] = {}

    def _path(self, class_str: str, suffix: str) -> str:
        strain, nc = class_str.split("|", 1)
        return os.path.join(self.icm_dir, strain, nc + suffix)

    def classes_icm_file(self, seq_classes: list[str]) -> str:
        """Classes_ICM_File (glimmer-mg.cc:473): best double else single."""
        key = ("icmfile",) + tuple(seq_classes)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        path = self._classes_icm_file(seq_classes)
        self._cache[key] = path
        return path

    def _classes_icm_file(self, seq_classes: list[str]) -> str:
        if len(seq_classes) >= 2:
            for i in range(1, len(seq_classes)):
                if seq_classes[0] < seq_classes[i]:
                    s1, s2 = seq_classes[0], seq_classes[i]
                else:
                    s1, s2 = seq_classes[i], seq_classes[0]
                st1, nc1 = s1.split("|", 1)
                st2, nc2 = s2.split("|", 1)
                path = os.path.join(self.icm_dir, st1, nc1 + "_2", st2, nc2 + ".gicm")
                if os.path.exists(path):
                    return path
        st1, nc1 = seq_classes[0].split("|", 1)
        return os.path.join(self.icm_dir, st1, nc1 + ".gicm")

    # -- cached per-class loads (Read_Meta_*) --

    def _cached(self, kind, class_str, loader):
        key = (kind, class_str)
        if key not in self._cache:
            self._cache[key] = loader()
        return self._cache[key]

    def gc(self, class_str: str) -> float:
        def load():
            p = self._path(class_str, ".gc.txt")
            try:
                return float(open(p).readline())
            except OSError:
                return 0.5

        return self._cached("gc", class_str, load)

    def rbs_pwm(self, class_str: str):
        """Raw-probability PWM for the meta mixture (Read_Meta_RBS)."""

        def load():
            pwm = feat.PWM.read(self._path(class_str, ".motif"))
            pwm.counts_to_prob()
            return pwm

        return self._cached("rbs", class_str, load)

    def lengths(self, class_str: str, min_gene_len: int):
        """(gene log-dist, non log-dist, prior) per Read_Meta_Lengths."""

        def load():
            def read_one(suffix):
                p = self._path(class_str, suffix)
                with open(p) as fh:
                    lines = iter(fh.read().splitlines())
                return ff.read_length_dist(lines, min_gene_len)

            gene_l, gene_ct = read_one(".lengths.genes.txt")
            non_l, non_ct = read_one(".lengths.non.txt")
            if gene_ct > 0 and non_ct > 0:
                prior = math.log(float(np.float32(gene_ct) / np.float32(non_ct)))
            else:
                prior = 0.0
            return gene_l, non_l, prior

        return self._cached(("len", min_gene_len), class_str, load)

    def starts(self, class_str: str):
        def load():
            def read_one(suffix):
                with open(self._path(class_str, suffix)) as fh:
                    return ff.read_start_dist(iter(fh.read().splitlines()))

            return read_one(".starts.genes.txt"), read_one(".starts.non.txt")

        return self._cached("starts", class_str, load)

    def adj_orients(self, class_str: str):
        def load():
            def read_one(suffix):
                with open(self._path(class_str, suffix)) as fh:
                    return ff.read_orient_dist(iter(fh.read().splitlines()))

            return read_one(".adj_orients.genes.txt"), read_one(".adj_orients.non.txt")

        return self._cached("adjor", class_str, load)

    def adj_dists(self, class_str: str, max_olap: int):
        def load():
            out = {}
            for key, tag in (("ff", "1.1"), ("fr", "1.-1"), ("rf", "-1.1")):
                for orf_type in ("genes", "non"):
                    p = self._path(class_str, f".adj_dist.{tag}.{orf_type}.txt")
                    with open(p) as fh:
                        d, _ = ff.read_dist_dist(iter(fh.read().splitlines()), max_olap)
                    out[(key, orf_type)] = d
            return out

        return self._cached(("adjdist", max_olap), class_str, load)

    def transl_table(self, class_str: str) -> int:
        """Read_Meta_Stops: grep transl_table= from the .gbk, default 11."""

        def load():
            p = self._path(class_str, ".gbk")
            try:
                with open(p) as fh:
                    for line in fh:
                        m = re.search(r"transl_table=(\d+)", line)
                        if m:
                            return int(m.group(1))
            except OSError:
                pass
            return 11

        return self._cached("transl", class_str, load)
