"""The JAX-free host layers of ``glimmer_mg_tpu`` that callers of the port need.

Re-exported so that a program driving the port (``chip_smoke.py``) imports
only ``glimmer_mg_torch``: base encoding, the model database reader and the
database trainer, the ICM file reader and writer, and the FASTA reader and
writer.
"""

from glimmer_mg_tpu.io.fasta import read_fasta, write_fasta
from glimmer_mg_tpu.io.genome_data import GenomeData
from glimmer_mg_tpu.models import dna
from glimmer_mg_tpu.models.icm import read_icm, write_icm
from glimmer_mg_tpu.pipeline.train_all import train_all

__all__ = ["GenomeData", "dna", "read_fasta", "read_icm", "train_all",
           "write_fasta", "write_icm"]
