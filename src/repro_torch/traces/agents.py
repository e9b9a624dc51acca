"""MetaGPT-style agent workload traces (paper SS4.4, Fig. 15).

A software "project" walks a role graph: architect -> engineers (per file)
-> QA -> engineers (revision), with the review/revision cycle run three
times.  Each role keeps its own session (its accumulated context = prompts
+ responses so far).  Because the call graph is known, an advisory fires
for the NEXT role the moment the current role starts running, carrying a
profiled lower-bound arrival time (paper: mean 5.8 s lead on 4xA100 —
ours is the profiled prefill+decode lower bound from the cost model).
"""
from __future__ import annotations

import itertools
from typing import List

import numpy as np

from repro_torch.core.advisory import AdvisoryRequest, InferenceRequest
from repro_torch.traces.sharegpt import Trace

N_ENGINEERS = 3
REVIEW_CYCLES = 3


class MetaGPTTrace(Trace):
    def __init__(self, n_projects: int = 16, seed: int = 0,
                 advisory: bool = True, ramp_s: float = 20.0):
        self.n_projects = n_projects
        self.rng = np.random.default_rng(seed)
        self.advisory = advisory
        self.ramp = ramp_s
        self._pid = itertools.count()

    def _doc(self):                       # design docs passed as context
        return int(np.clip(self.rng.lognormal(7.8, 0.4), 1024, 8192))

    def _code(self):                      # generated code/review chunks
        return int(np.clip(self.rng.lognormal(5.6, 0.4), 128, 1024))

    def _project_steps(self) -> List[dict]:
        """Linearized role-call list: session id suffix, prompt, response."""
        steps = [dict(role="architect", prompt=self._doc(), resp=self._doc())]
        for e in range(N_ENGINEERS):
            steps.append(dict(role=f"eng{e}", prompt=self._doc(),
                              resp=self._code()))
        for _cycle in range(REVIEW_CYCLES):
            steps.append(dict(role="qa", prompt=self._code(),
                              resp=self._doc()))
            for e in range(N_ENGINEERS):
                steps.append(dict(role=f"eng{e}", prompt=self._doc(),
                                  resp=self._code()))
        return steps

    def _spawn_project(self, pid: int, t0: float):
        """Per-project scope (avoids late-binding closure bugs: each project
        owns its cb)."""
        steps = self._project_steps()
        state = dict(i=0)

        def make_req(i: int, t: float) -> InferenceRequest:
            s = steps[i]
            return InferenceRequest(
                session_id=f"p{pid}-{s['role']}", prompt_tokens=s["prompt"],
                max_new_tokens=s["resp"], arrival=t)

        def cb(req, now):
            state["i"] += 1
            i = state["i"]
            ev = []
            if i < len(steps):
                t_req = now + 0.2               # framework glue latency
                ev.append((now, "chain", (f"p{pid}-{steps[i]['role']}", cb)))
                ev.append((t_req, "request", make_req(i, t_req)))
            return ev

        evs = [(t0, "chain", (f"p{pid}-{steps[0]['role']}", cb)),
               (t0, "request", make_req(0, t0))]
        if self.advisory:
            # call graph known ahead: advisory for step i+1 fires when step i
            # STARTS (profiled lower bound on its runtime)
            t = t0
            for i in range(1, len(steps)):
                t_lb = t + 1.0
                sid = f"p{pid}-{steps[i]['role']}"
                evs.append((t_lb, "advisory", AdvisoryRequest(
                    session_id=sid, expected_arrival=t_lb + 3.0)))
                t = t_lb + 3.0
        return evs

    def events(self):
        evs = []
        for _p in range(self.n_projects):
            pid = next(self._pid)
            t0 = float(self.rng.uniform(0, self.ramp))
            evs.extend(self._spawn_project(pid, t0))
        return evs
