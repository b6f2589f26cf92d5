"""The fused forward's share of its roofline over the traced predict
requests."""
from stbench import yardstick


def read(obs):
    return yardstick.fused_roofline_pct(obs.get("span"), "fwd")
