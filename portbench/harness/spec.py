"""Where the benchmark's data lives, found by name.

``BENCHMARK.json`` at the root of the checkout names the cells; a cell's
configuration is the file its ``configs`` entry names, its traffic mix is
``traffic/<traffic>.json``, a per-layer metric is the reader
``metrics/<metric>.py`` and the layers a traced run wraps are every
``layers/*.json``, all under this folder.  Adding a cell, a configuration,
a mix or a metric adds files and entries and edits none.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parents[1]      # portbench/
ROOT = HERE.parent                                      # the checkout


@dataclasses.dataclass
class Cell:
    """One workload of BENCHMARK.json with its files read."""
    name: str
    chips: int
    config: dict          # the configuration file
    traffic: dict         # the traffic file
    end_to_end: list      # the BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def env_id(self) -> str:
        c = self.config
        return f'{c["task"]}-{self.traffic["variant"]}-{c["preproc"]}-v0'


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / 'BENCHMARK.json').read_text())


def _reports(entry: dict, name: str) -> bool:
    return 'workloads' not in entry or name in entry['workloads']


def cell(name: str, root: pathlib.Path = ROOT,
         here: pathlib.Path = None) -> Cell:
    """The workload `name` of `root`'s BENCHMARK.json, its configuration
    and traffic files read from `here` (this folder in `root`)."""
    here = here or root / HERE.name
    bench = benchmark(root)
    work = {w['name']: w for w in bench['workloads']}
    if name not in work:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json: '
                       f'{sorted(work)}')
    w = work[name]
    config = {c['name']: c for c in bench['configs']}[w['config']]
    return Cell(
        name=name, chips=int(w['chips']),
        config=json.loads((root / config['file']).read_text()),
        traffic=json.loads(
            (here / 'traffic' / f'{w["traffic"]}.json').read_text()),
        end_to_end=[m for m in bench['end_to_end'] if _reports(m, name)],
        per_layer=[m for m in bench['per_layer'] if _reports(m, name)])


def load_metric(name: str, here: pathlib.Path = HERE):
    """The reader module ``metrics/<name>.py``: its ``read(ctx)`` gives the
    metric's value, or None where the run has nothing to read."""
    path = here / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f'portbench_metric_{name.replace(".", "_").replace("-", "_")}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def layers(here: pathlib.Path = HERE) -> list:
    """Every ``layers/*.json``, in name order."""
    return [json.loads(p.read_text())
            for p in sorted((here / 'layers').glob('*.json'))]
