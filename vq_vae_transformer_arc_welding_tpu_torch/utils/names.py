"""Run-name generator (capability parity with reference utils.py:52-62).

Own copy of vq_vae_transformer_arc_welding_tpu/utils/names.py: the same
word lists and draws, so one `random.seed` gives the same names in both
packages.
"""
import random

_ADJECTIVES = ["Brisk", "Quiet", "Vivid", "Merry", "Nimble", "Plucky", "Sunny", "Zesty"]
_NOUNS = ["Anvil", "Arc", "Bead", "Electrode", "Flux", "Plasma", "Seam", "Spark",
          "Torch", "Weld", "Crater", "Puddle", "Filler", "Clamp", "Gauge", "Nozzle"]


def generate_funny_name() -> str:
    return (f"{random.choice(_ADJECTIVES)}-{random.choice(_NOUNS)}-"
            f"{str(random.randint(0, 1000)).zfill(3)}")


def name_generator(length: int = 10) -> str:
    """Random ascii run name (parity: reference utils.py:45-48)."""
    import string
    return "".join(random.choice(string.ascii_letters)
                   for _ in range(length))
