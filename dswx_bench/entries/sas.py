"""The SAS entry: one product run a granule through ``cli/dswx_hls.py``'s
``main``, in-process, one after another.

Each product run parses its runconfig and calls ``generate_dswx_layers``
as the CLI does, and writes its ten layers and browse into a directory of
its own. The stage breakdown that ``generate_dswx_layers`` logs
(``StageTimers``) is read by a logging handler. The CLI's logger gains a
console handler and takes over ``sys.stdout`` and ``sys.stderr`` in every
run; both are put back after each. With a trace (``spans``, a
``trace.HostSpans``), the program's stages are wrapped in host spans.
"""

import logging
import os
import re
import sys
import time

from proteus_tpu_torch.cli import dswx_hls
from proteus_tpu_torch.io import hls
from proteus_tpu_torch.runtime import orchestrator as orch

from dswx_bench import trace
from dswx_bench.generate import write_runconfig

_STAGE_LINE = re.compile(r'^\s{4}(.+?)\s+(-?[\d.]+)s\s+-?[\d.]+%$')


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def stage_seconds(lines):
    """{stage: seconds} of the last 'stage timing breakdown:' in ``lines``
    (the total left out)."""
    try:
        at = len(lines) - 1 - lines[::-1].index('stage timing breakdown:')
    except ValueError:
        return {}
    out = {}
    for line in lines[at + 1:]:
        m = _STAGE_LINE.match(line)
        if not m:
            break
        if m.group(1) != 'total':
            out[m.group(1)] = float(m.group(2))
    return out


# settings the SAS fixes; a configuration that states another value is
# refused, not run with the program's
FIXED = {'landcover_mask_type': 'standard', 'dem_margin_px': 50}


class Entry:
    def __init__(self, config, mix, inputs, work, device, spans):
        for key, value in FIXED.items():
            if config['processing'][key] != value:
                raise ValueError(f'the SAS fixes {key} at {value!r}; the '
                                 f'configuration states '
                                 f'{config["processing"][key]!r}')
        self.cli = dswx_hls
        self.device = str(device)
        self.inputs = inputs
        self.work = work
        self.spans = spans
        self.processing = config['processing']
        self.warmup = mix['warmup_products']
        self.acquisition = inputs.acquisitions[0]
        self.products = []
        self.stage_timers = []

    def _product(self, label):
        p = self.processing
        out = os.path.join(self.work, 'out', label)
        os.makedirs(out, exist_ok=True)
        rc = write_runconfig(
            os.path.join(self.work, f'runconfig_{label}.yaml'),
            os.path.dirname(self.acquisition.files[0]), out,
            os.path.join(self.work, 'scratch', label),
            self.inputs.ancillaries, p)
        logger = logging.getLogger('dswx_hls')
        handlers = list(logger.handlers)
        capture = _Capture()
        logger.addHandler(capture)
        streams = sys.stdout, sys.stderr
        os.environ['PROTEUS_TPU_TORCH_DEVICE'] = self.device
        try:
            ok = self.cli.main([rc])
        finally:
            sys.stdout, sys.stderr = streams
            for h in list(logger.handlers):
                if h not in handlers:
                    logger.removeHandler(h)
        prefix = f'{p["product_id"]}_v{p["product_version"]}_'
        return bool(ok), (out, prefix, self.acquisition), \
            stage_seconds(capture.lines)

    def warm_up(self):
        for k in range(self.warmup):
            ok, _, _ = self._product(f'warmup{k}')
            if not ok:
                raise RuntimeError('warm-up product run failed')

    def _products(self, seconds):
        t0 = time.perf_counter()
        k = failed = 0
        product_s = []
        while True:
            t = time.perf_counter()
            ok, product, stages = self._product(f'p{k:03d}')
            product_s.append(time.perf_counter() - t)
            self.products.append(product)
            self.stage_timers.append(stages)
            failed += not ok
            k += 1
            if time.perf_counter() - t0 >= seconds:
                break
        return {'window_s': time.perf_counter() - t0, 'products': k - failed,
                'attempted': k, 'failed': failed, 'product_s': product_s}

    def window(self, seconds):
        if self.spans is None:
            return self._products(seconds)
        pw = getattr(orch, 'pw', None)
        targets = [(hls, 'load_hls_product_v2', 'sas.ingest'),
                   (orch, 'warp_to_grid_device', 'sas.warp'),
                   (orch, 'compute_opera_shadow_layer_exact', 'sas.shadow'),
                   (orch, 'create_landcover_mask_arrays', 'sas.land'),
                   (orch, 'wtr_layers', 'sas.per_pixel_chain'),
                   (pw, 'save_array', 'sas.save_layer'),
                   (pw, 'save_dswx_product', 'sas.save_layer'),
                   (pw, 'save_cloud_layer', 'sas.save_layer'),
                   (pw, 'save_binary_water', 'sas.save_layer'),
                   (orch, 'geotiff2png', 'sas.browse_png'),
                   (orch, 'generate_dswx_layers', 'sas.product')]
        # a later program may have moved a stage: its span is left out
        targets = [t for t in targets if hasattr(t[0], t[1])]
        with trace.annotate(targets, self.spans):
            return self._products(seconds)

    def close(self):
        pass
