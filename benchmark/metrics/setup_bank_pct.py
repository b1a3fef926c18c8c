"""Share of set-up (setup_s) in the classification bank's build, the
program's spans phymm.bank.read, .stack, .pack and .upload, host clock."""

UNIT = "%"

NAMES = ("phymm.bank.read", "phymm.bank.stack", "phymm.bank.pack",
         "phymm.bank.upload")


def read(t):
    setup = t.program_spans_setup
    if not any(n in setup for n in NAMES) or t.setup_s <= 0:
        return None
    return 100.0 * sum(setup.get(n, 0.0) for n in NAMES) / t.setup_s
