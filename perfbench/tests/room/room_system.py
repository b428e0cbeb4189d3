"""A system module for the room test: the port's store and ``GOpt`` over
data of its own, which ``snb.generate(generator_scale, seed)`` cannot
give: the frozen generator under a seed stream of its own, with a seeded
third of the persons' KNOWS edges dropped."""
import numpy as np

from perfbench import snb, system

CPU_SIZES = {"room_scale": 0.25}
KNOWS = ("PERSON", "KNOWS", "PERSON")


def data(config: dict, seed: int) -> snb.RawGraph:
    raw = snb.generate(config["room_scale"], [seed, 35])
    src, dst = raw.edges[KNOWS]
    keep = np.random.default_rng([seed, 36]).random(src.shape[0]) >= 1 / 3
    raw.edges[KNOWS] = (src[keep], dst[keep])
    raw.e_props[KNOWS] = {k: v[keep] for k, v in raw.e_props[KNOWS].items()}
    return raw


def build(config: dict, seed: int, device):
    return system.build_with(data, config, seed, device)
