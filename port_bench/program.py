"""The system under test, jpeg_tpu_torch, called the way a traffic mix says.

This is the only module of the benchmark that imports the program.  A mix
names its ``entry`` as a dotted path under the package
(``decompress_many``, ``parallel.decompress_batch``), what it ``takes``
(``frames`` or ``containers``), and how a call passes its arguments:
``args`` lists the positional ones and ``named`` the keyword ones, each
one of

* ``items``: the call's list of inputs (a batched entry),
* ``item``: its one input (a single-image entry),
* ``config``: the configuration's ``Configuration``,
* ``dtype``: its working precision as the API takes it,
* ``device``: the run's device;

``kwargs`` holds the rest.  A call returns one answer per input, and has
finished on the device when it returns.  An entry whose arguments these
cannot give (a device mesh) brings its own ``make_call`` in a
``traffic/<name>.py`` beside the mix's JSON.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import torch


def import_program():
    import jpeg_tpu_torch
    return jpeg_tpu_torch


def configuration(api, codec: Dict, height: int, width: int):
    """The program's Configuration for a configuration file's ``codec``."""
    q = codec["quantization"]
    return api.Configuration(
        width=width, height=height, block_size=codec["block_size"],
        dct_size=codec["dct_size"], transform=codec["transform"],
        quantization=api.QuantizationMethod(q["name"], **q.get("params", {})))


def dtype_of(codec: Dict):
    """The configuration's working precision as the API takes it."""
    name = codec.get("dtype", "float32")
    if name != "float32":
        raise ValueError(f"unsupported dtype {name!r}")
    return None


def entry_of(api, path: str):
    fn = api
    for part in path.split("."):
        fn = getattr(fn, part)
    return fn


def batched(mix: Dict) -> bool:
    """Whether a call of the mix's entry takes a list of inputs."""
    return "items" in mix["args"]


def make_call(api, mix: Dict, codec: Dict, height: int, width: int,
              device: str) -> Callable[[List], List]:
    """A function from a list of inputs to the list of answers."""
    fn = entry_of(api, mix["entry"])
    values = {"config": configuration(api, codec, height, width),
              "dtype": dtype_of(codec), "device": device}
    named = {n: values[n] for n in mix.get("named", [])}
    kw = dict(mix.get("kwargs", {}), **named)
    dev = torch.device(device)
    many = batched(mix)

    def call(items: List) -> List:
        v = dict(values, items=items, item=items[0])
        out = fn(*[v[a] for a in mix["args"]], **kw)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return list(out) if many else [out]
    return call
