"""The steady frame as one CUDA graph replay: the counterpart of the
reference's jitted ``_steady_step`` and ``_steady_step_kf`` (port of
runtime/pipeline.py's single-dispatch steady step).

``StepGraphs`` runs ``OnlineReconstructor._steady_step`` on static buffers:

- the packed frame is copied into a static uint8 buffer (after the
  prefetcher's upload, which the current stream already waits for);
- the tracking target (the last keyframe's features, pose and prior) lives
  in static buffers, refilled from the host's last keyframe only when the
  host replaced it (the first frame, a resumed snapshot); a keyframe step
  writes the new frame's features, refined pose and prior into them itself;
- the staging map pool and the device BA window are updated in place, the
  counterpart of the reference's donated buffers.

One graph per static variant, keyed as the reference keys its compiled
programs by ``static_argnames``: (``fuse``, ``ba_event``, keyframe,
``precomputed_disp``, ``skip_rectify``); keyframe is ``ba_event`` when the
engine has a device window, and otherwise tells the step to take over the
tracking target. A variant's first frame runs eagerly on a side stream
(the warm-up: lazy initialisation, the kernels' build and their line
tables happen there, never inside a capture), then the body is captured
once; every later frame of that variant is one ``replay``. The body never
waits for the host, so nothing else is needed. A capture that fails raises:
there is no fallback to eager execution on the card.

Whatever the host keeps is copied out of the graph's memory right after
the replay, in one small copy for the pose, prior and VO scalars (and, on a
keyframe, the features and the refined window), so the next replay cannot
overwrite it. The kernels' launch counters (``cuda_build.launch_counts``)
are bumped by their Python wrappers, which a replay does not call: the
capture records the counters' growth and each replay adds it. With the
engine's tracing on, the captured body holds the stages' device stamps
(runtime/trace.py), which read the frame index from the packed header, and
``step`` records the host spans ``step.load``, ``step.sync_keyframe``,
``step.replay`` (the graph launch), ``step.capture`` and ``step.keep``.

With ``capture=False`` the same static buffers and body run eagerly, their
outputs copied into one place per variant as a graph's stay in its memory
(on the CPU: the tests hold this path bit-equal to the eager engine, and
the host's kept values unchanged by the next step).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import torch

from online_3d_reconstruction_tpu_torch.utils import cuda_build

_KEY_NAMES = ("fuse", "ba_event", "keyframe", "precomputed_disp", "skip_rectify")


def _same(a: Tuple, b: Tuple) -> bool:
    """Whether two tuples hold the very same objects."""
    return len(a) == len(b) and all(x is y for x, y in zip(a, b))


def _keyframe_tensors(kf) -> List[torch.Tensor]:
    """The tensors of a keyframe (``runtime.pipeline._Keyframe``), in a
    fixed order: the keypoints' six, the lifts, their validity, pose, prior."""
    f = kf.features
    return [*f.keypoints, f.points3d, f.valid3d, kf.pose, kf.prior_pose]


class _Variant:
    """A captured step: its graph, the outputs it writes, the launch counts
    its replay stands for, and what the capture cost."""

    def __init__(self, graph, outputs, launches: Dict[str, int], capture_ms: float,
                 pool_bytes: int):
        self.graph = graph
        self.outputs = outputs
        self.launches = launches
        self.capture_ms = capture_ms
        self.pool_bytes = pool_bytes
        self.replays = 0


class StepGraphs:
    """The static-buffer steady step of one engine (see the module
    docstring). ``capture`` (CUDA only) records one graph per variant and
    replays it; without it the body runs eagerly on the same buffers."""

    def __init__(self, engine, capture: bool):
        if capture and engine.device.type != "cuda":
            raise ValueError("a CUDA graph needs the engine on a CUDA device, "
                             f"got {engine.device}")
        self._engine = engine
        self.capture = capture
        self._packed: Dict[bool, torch.Tensor] = {}
        self._kf = None               # static tracking target (a _Keyframe)
        self._kf_from: Tuple = ()     # the host tensors its values came from
        self._bound: Tuple = ()       # the pools the graphs write in place
        self._graphs: Dict[tuple, _Variant] = {}
        self._captures = 0
        self._held: Dict[tuple, tuple] = {}   # the outputs without capture
        self._stream = torch.cuda.Stream(engine.device) if capture else None

    # -- static inputs -------------------------------------------------------

    def _load(self, packed, use_disp: bool) -> None:
        src = torch.as_tensor(packed)
        buf = self._packed.get(use_disp)
        if buf is None:
            buf = self._packed[use_disp] = torch.empty(
                src.numel(), dtype=torch.uint8, device=self._engine.device)
        if src.dtype != torch.uint8 or src.numel() != buf.numel():
            raise ValueError(f"packed frame of {src.numel()} {src.dtype} values, the "
                             f"engine's frames are {buf.numel()} uint8 values")
        buf.copy_(src.reshape(-1))

    def _sync_keyframe(self) -> None:
        """Refill the tracking target from the host's last keyframe where the
        host replaced it since the last step."""
        host = self._engine.keyframes[-1]
        source = (host.features, host.pose, host.prior_pose)
        if _same(source, self._kf_from):
            return
        if self._kf is None:
            self._kf = self._keyframe_of([t.clone() for t in _keyframe_tensors(host)])
        else:
            for dst, src in zip(_keyframe_tensors(self._kf), _keyframe_tensors(host)):
                dst.copy_(src)
        self._kf_from = source

    @staticmethod
    def _features_of(tensors):
        """``FrameFeatures`` of the first eight of ``_keyframe_tensors``."""
        from online_3d_reconstruction_tpu_torch.features.brief import Keypoints
        from online_3d_reconstruction_tpu_torch.odometry.frontend import FrameFeatures

        return FrameFeatures(keypoints=Keypoints(*tensors[:6]), points3d=tensors[6],
                             valid3d=tensors[7])

    def _keyframe_of(self, tensors):
        """A ``_Keyframe`` made of ``tensors`` in ``_keyframe_tensors`` order."""
        from online_3d_reconstruction_tpu_torch.runtime.pipeline import _Keyframe

        return _Keyframe(index=-1, features=self._features_of(tensors), pose=tensors[8],
                         prior_pose=tensors[9])

    # -- the body ------------------------------------------------------------

    def _body(self, key):
        """One steady frame on the static buffers. Returns (record, refined
        window or None): record = pose (16) | prior (16) | used_vo | inliers,
        float32."""
        fuse, ba_event, keyframe, use_disp, _ = key
        pose, prior, feats, used_vo, count, _, refined = self._engine._steady_step(
            self._packed[use_disp], self._kf, fuse, ba_event, use_disp)
        record = torch.cat([pose.reshape(16), prior.reshape(16),
                            used_vo.to(pose.dtype).reshape(1),
                            count.to(pose.dtype).reshape(1)])
        if keyframe:   # the frame becomes the tracking target
            new = [*feats.keypoints, feats.points3d, feats.valid3d, pose, prior]
            for dst, src in zip(_keyframe_tensors(self._kf), new):
                dst.copy_(src)
        return record, refined

    def _capture(self, key):
        """The variant's first frame: the body eagerly on the side stream,
        then its capture. Returns the eager run's outputs."""
        dev = self._engine.device
        current = torch.cuda.current_stream(dev)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            outputs = self._body(key)
        current.wait_stream(self._stream)
        for t in outputs:
            if t is not None:
                t.record_stream(current)
        graph = torch.cuda.CUDAGraph()
        before = dict(cuda_build.launch_counts)
        t0 = time.perf_counter()
        # thread_local: the prefetcher's worker keeps using the card meanwhile
        with torch.cuda.graph(graph, stream=self._stream,
                              capture_error_mode="thread_local"):
            reserved = torch.cuda.memory_reserved(dev)
            captured = self._body(key)
        capture_ms = 1e3 * (time.perf_counter() - t0)
        pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        # the capture launched nothing: its counts are what a replay stands for
        launches = {name: n - before[name] for name, n in cuda_build.launch_counts.items()
                    if n != before[name]}
        cuda_build.launch_counts.update(before)
        self._graphs[key] = _Variant(graph, captured, launches, capture_ms, pool_bytes)
        self._captures += 1
        return outputs

    def step(self, packed, fuse: bool, ba_event: bool, keyframe: bool, use_disp: bool):
        """One steady frame. Returns (pose (4, 4), prior (4, 4), the frame's
        features on a keyframe else None, used_vo (), inliers (), refined
        window (W, 4, 4) or None), none of them in the buffers the next step
        writes; used_vo and inliers are float32 0-dim tensors."""
        engine = self._engine
        tr, index = engine.trace, engine.frame_idx
        key = (fuse, ba_event, keyframe, use_disp, engine._skip_rectify)
        bound = (engine._staging, engine._ba_state)
        if not _same(bound, self._bound):
            # a snapshot replaced the pools: graphs of the old ones are stale
            self._graphs = {}
            self._bound = bound
        with tr.span("step.load", index):
            self._load(packed, use_disp)
        with tr.span("step.sync_keyframe", index):
            self._sync_keyframe()
        if not self.capture:
            # like a graph's outputs, they stay in one place that the next
            # step of the variant rewrites
            outputs = self._body(key)
            if key not in self._held:
                self._held[key] = tuple(None if t is None else torch.empty_like(t)
                                        for t in outputs)
            held = self._held[key]
            for dst, src in zip(held, outputs):
                if src is not None:
                    dst.copy_(src)
            record, refined = held
        elif key in self._graphs:
            variant = self._graphs[key]
            with tr.span("step.replay", index):
                variant.graph.replay()
            variant.replays += 1
            for name, n in variant.launches.items():
                cuda_build.launch_counts[name] += n
            record, refined = variant.outputs
        else:
            with tr.span("step.capture", index):
                record, refined = self._capture(key)
        with tr.span("step.keep", index):
            kept = record.clone()
            pose, prior = kept[:16].view(4, 4), kept[16:32].view(4, 4)
            feats = None
            if keyframe:
                feats = self._features_of([t.clone() for t in _keyframe_tensors(self._kf)[:8]])
                # the host's keyframe will hold these: no refill before the next step
                self._kf_from = (feats, pose, prior)
            return (pose, prior, feats, kept[32], kept[33],
                    None if refined is None else refined.clone())

    def stats(self) -> Optional[dict]:
        """What the graphs cost and did: the captures so far, and per live
        variant its key, capture ms, graph memory (MiB the capture added to
        the allocator's reserve), replays and the kernel launches a replay
        stands for; None without capture."""
        if not self.capture:
            return None
        variants = [dict(zip(_KEY_NAMES, key), capture_ms=v.capture_ms,
                         graph_mib=v.pool_bytes / 2**20, replays=v.replays,
                         launches_per_replay=v.launches)
                    for key, v in self._graphs.items()]
        return {"captures": self._captures,
                "replays": sum(v["replays"] for v in variants), "variants": variants}
