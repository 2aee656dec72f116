"""Extraction traffic: whole passes of ``pipelines.extract.extract_latents``
over a set of images in pageable host memory, float32 NHWC as
``load_dataset`` hands it to ``extract-latents``, at the traffic's batch.

Set-up draws the weights and the images (on the card, then copied to host
memory once) and runs one pass, which warms both of the pass's batch
shapes. Every pass of the window keeps its codes for the check.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from yardstick import inputs, judge
from yardstick.reference.precision import fp32

# the rows of the check's reference at a time
BLOCK = 4096


class ExtractCell:
    unit_name = "yardstick.extract_latents"
    counts = "images"      # what ``attempted`` and ``failed`` count

    def __init__(self, spec, seed: int, device, rank: int = 0, mesh_cfg=None):
        self.spec, self.seed, self.device = spec, seed, torch.device(device)
        self.cfg, self.traffic = spec.config, spec.traffic
        self.model = spec.model()
        self.ref = self.model.reference
        self.passes = []

    def make_inputs(self):
        images, _stats = self.model.make_data(self.traffic["n_images"], self.cfg, self.seed, self.device)
        self.data = images.cpu().numpy()
        del images
        self.params0 = inputs.weights(self.ref.param_specs(self.cfg), self.seed, self.device)

    def setup(self, mark=lambda name: None):
        self.make_inputs()
        mark("inputs")
        self.program = self.model.Extraction(self.cfg, self.params0, self.device)
        mark("program")
        self.program.run(self.data, self.traffic["batch_size"])
        mark("warm pass")

    def unit(self):
        with torch.profiler.record_function(self.unit_name):
            self.passes.append(self.program.run(self.data, self.traffic["batch_size"]))
        n, b = len(self.data), self.traffic["batch_size"]
        return math.ceil(n / b), n, None      # a pass returns its codes on the host

    def settle(self, _out):
        pass

    def release(self):
        self.program = None
        torch.cuda.empty_cache()

    def reference_codes(self, mode: str):
        """The reference's codes of every image in ``mode``'s arithmetic (the
        control puts them in the program's place)."""
        out = []
        with torch.no_grad(), fp32(mode):
            for s in range(0, len(self.data), BLOCK):
                x = torch.from_numpy(self.data[s:s + BLOCK]).to(self.device)
                out.append(self.ref.codes(self.params0, x, self.cfg).to(torch.int32).cpu().numpy())
        return np.concatenate(out)

    def numbers(self, passes=None, gap_limit=math.inf):
        return judge.extraction(passes or self.passes, self.data,
                                lambda x: self.ref.encode(self.params0, x, self.cfg),
                                self.params0["codebook"], BLOCK, self.device, gap_limit)

    def check(self, limits: dict):
        return self.numbers(gap_limit=limits["code_gap"])

    # -- the readings the limits are set from (``control.py``) ---------------

    def program_numbers(self):
        """The numbers of one pass after set-up's, once the program is freed."""
        self.unit()
        self.release()
        return self.numbers()[0]

    def control_numbers(self, fault: str = None):
        """The reference's codes in TF32 in the program's place."""
        if fault is not None:
            raise ValueError(f"extraction plants no fault {fault!r}")
        self.make_inputs()
        return self.numbers(passes=[self.reference_codes("tf32")])[0]


CELL = ExtractCell
