"""Frozen copies of the port's host modules (glimmer_mg_torch at commit
ab5a5d3), in the port's subpackage layout so that their relative imports
stand unchanged. The benchmark's database builder and its plain reference
run on them, so a later change to the port moves neither the data nor the
yardstick. They import numpy and the standard library only."""
