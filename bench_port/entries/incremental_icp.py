"""The entry of the incremental configurations:
``rspc_tpu_torch.registration.schemes.IncrementalICP(config).registration``
on one sweep's clouds per call (``batch`` 1), configured as the program's
defaults with the configuration file's ``pipeline`` set. Its answer: per
pair the transform, convergence and ICP iterations; for the calls the
check samples, also the merged map (xyz and valid rows)."""

from __future__ import annotations

import torch

from bench_port.references.incremental_icp import voxel_count
from bench_port.spec import replaced


class Entry:
    def __init__(self, cell: dict, pool: dict, device):
        from rspc_tpu_torch.cloud import OrganizedCloud
        from rspc_tpu_torch.config import PipelineConfig

        mix = cell["mix"]
        if mix["batch"] != 1:
            raise ValueError("incremental_icp runs one sweep a call")
        self.cfg = cell["config"]
        self.config = replaced(PipelineConfig(), self.cfg["pipeline"])
        self.sweeps_per_call = 1
        self.payloads = [
            ([j], [OrganizedCloud(xyz=pool[j].xyz[i], rgb=pool[j].rgb[i],
                                  valid=pool[j].valid[i]) for i in range(mix["frames"])])
            for j in sorted(pool)]
        self._pool = pool
        self._counts: dict = {}

    def run(self, frames):
        from rspc_tpu_torch.registration.schemes import IncrementalICP

        scheme = IncrementalICP(self.config)
        merged = scheme.registration(frames)
        return scheme.results, merged

    def host(self, out) -> dict:
        results, _ = out
        return {"transforms": torch.stack([r.transform for r in results]).cpu().numpy(),
                "converged": torch.stack([r.converged for r in results]).cpu().numpy(),
                "iterations": torch.stack([r.iterations for r in results]).cpu().numpy()}

    def extra(self, out) -> dict:
        """The merged map, copied to the host."""
        _, merged = out
        return {"map_xyz": merged.xyz.cpu().numpy(), "map_valid": merged.valid.cpu().numpy()}

    def answers(self, record: dict):
        """(sweep index, answer) of each sweep of one call."""
        yield record["sweeps"][0], {**record["host"], **record.get("extra", {})}

    def nn_sweeps(self, record: dict) -> list:
        """(valid sources, valid target rows) of every NN sweep the call's
        ICPs made: per pair its iterations of voxel means against the map's
        valid rows so far (frame 0, and each earlier frame whose ICP
        converged), counted from the inputs."""
        j = record["sweeps"][0]
        if j not in self._counts:
            sw, leaf = self._pool[j], self.cfg["pipeline"]["voxel"]["leaf_size"]
            self._counts[j] = (
                [voxel_count(sw.xyz[i], sw.valid[i], leaf) for i in range(sw.xyz.shape[0])],
                sw.valid.reshape(sw.valid.shape[0], -1).sum(1).tolist())
        sources, rows = self._counts[j]
        host, out, tgt = record["host"], [], rows[0]
        for i in range(1, len(rows)):
            out += [(sources[i], tgt)] * int(host["iterations"][i - 1])
            if bool(host["converged"][i - 1]):
                tgt += rows[i]
        return out
