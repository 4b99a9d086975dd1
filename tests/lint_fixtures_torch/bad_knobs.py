"""TPU703 fixture: knob reads that drift from CONFIG_DEFS.

A typo'd config.get key, two raw environ reads that bypass the
registry, and a declared knob nothing ever reads.
"""

import os

CONFIG_DEFS = {
    "ALPHA_TIMEOUT_S": (float, 5.0, "alpha timeout"),
    "BETA_RETRIES": (int, 3, "beta retry count"),
    "GAMMA_DEAD": (int, 0, "declared but never read"),
}


class config:
    """Stand-in registry so ``config.get`` resolves syntactically."""

    @staticmethod
    def get(name):
        return CONFIG_DEFS[name][1]


def read_things():
    a = config.get("ALPHA_TIMEOUT_S")
    b = config.get("BETA_RETRY")
    c = os.environ["RAY_TPU_ALPHA_TIMEOUT_S"]
    d = os.environ.get("RAY_TPU_BETA_RETRIES")
    return a, b, c, d
