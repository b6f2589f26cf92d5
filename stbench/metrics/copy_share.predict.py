"""The share of the traced span of predict requests spent in host-device
copies."""
from stbench import yardstick


def read(obs):
    return yardstick.copy_pct(obs.get("span"))
