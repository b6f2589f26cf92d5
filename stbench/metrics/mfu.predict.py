"""The traced predict requests' product FLOPs as a share of the
float32-accurate product peak."""
from stbench import yardstick


def read(obs):
    return yardstick.mfu_pct(obs.get("span"), obs["model"])
