"""Streaming odometry in chunks of frames: upload and compute pipelined.

Counterpart of ``loam_tpu.odometry.streaming``. The reference's usage model
is a serial loop (``README.md:44-60``: read scan -> extractFeatures ->
registerFeatures -> compose). This driver runs it in chunks of K frames:

  1. the frames of a chunk are gathered on the host, by default in the
     4-byte/point packed format (``io/packed.py``), a third of the bytes of
     the float32 grids; from files, the native loader's worker threads read,
     project and pack them ahead of the consumer (``io/native.py``);
  2. the chunk goes to the GPU from a pinned host buffer with a non-blocking
     copy and is decoded there;
  3. one batched extraction and one lockstep registration of the K pairs
     follow, all enqueued without reading a result back, so the host gathers
     chunk c+1 while the GPU works on chunk c (the ICF loop's own
     ``running.any()`` once an iteration is the only synchronisation).

Each chunk registers its K frames against their predecessors, carrying the
previous chunk's boundary features (no frame is extracted twice) and its last
relative pose (the constant-velocity prior of
``odometry_offline(motion_init=True)``). The very first pair registers frame 0
against an empty feature set, which ends with ``INSUFFICIENT_ASSOCIATIONS`` at
its identity init (SURVEY 2.3(9)): the reference's "first scan just
initializes", with no special case.
"""

from __future__ import annotations

import os
from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..device import resolve
from ..dewarp import dewarp_scan
from ..features import FeatureSet, extract_features_batch
from ..geometry import Pose3, pose_cumcompose
from ..io.native import ScanLoader
from ..io.packed import PACKED_R_MAX, decode_packed, encode_packed_grid
from ..params import FeatureExtractionParams, LidarParams, RegistrationParams
from ..registration import RegistrationDetail, azimuth_sort_features, register_features_batch
from ..registration.detail import tree_map
from .scan_to_scan import scan_to_scan_init


class StreamCarry(NamedTuple):
    """What one chunk step hands to the next, on the device."""

    prev_feats: FeatureSet  # azimuth-sorted features of the last frame seen
    prev_delta: Pose3       # its converged relative pose (the motion prior)
    world: Pose3            # world_T_last_frame


def stream_init(
    lidar: LidarParams,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
    dtype=torch.float32,
    device=None,
) -> StreamCarry:
    """The carry before the first frame: empty features, identity poses, on
    the card unless ``device`` says otherwise (``device.py``)."""
    s = scan_to_scan_init(lidar, feat_params, dtype, device)
    return StreamCarry(prev_feats=s.prev_features, prev_delta=s.prev_delta, world=s.world_T_current)


def stream_chunk_step(
    carry: StreamCarry,
    chunk: torch.Tensor,
    lidar: LidarParams,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
    reg_params: RegistrationParams = RegistrationParams(),
    packed_cfg: Optional[Tuple[float, float, float]] = None,
    motion_init: bool = True,
    dewarp: bool = False,
) -> Tuple[StreamCarry, Pose3, RegistrationDetail]:
    """Process K frames: extract, register each against its predecessor.

    Args:
      chunk: (K, L, P, 3) float32 scans, or (K, 4, L, P) uint8 packed planes
        when ``packed_cfg`` is set; it runs where the chunk lies.
      packed_cfg: (elev_lo, elev_hi, r_max) of the packed format.

    Returns (new carry, world poses of these K frames, detail with (K, ...)
    leaves). Pair j registers frame j against frame j-1 (the carry's boundary
    features for j = 0), all K in lockstep: the math of ``odometry_offline``'s
    chunked form, reshaped for a stream.
    """
    scans = decode_packed(chunk, *packed_cfg) if packed_cfg is not None else chunk
    K = scans.shape[0]
    if dewarp:
        # constant-velocity motion compensation with the carried previous
        # relative pose, the prior of scan_to_scan_step(dewarp=True), applied
        # to every frame of the chunk
        scans = dewarp_scan(scans, carry.prev_delta, lidar)
    feats = extract_features_batch(scans, lidar, feat_params, post=azimuth_sort_features)
    dtype, dev = feats.edge_points.dtype, feats.edge_points.device
    tgt = tree_map(lambda prev, f: torch.cat([prev[None], f[:-1]]), carry.prev_feats, feats)
    if motion_init:
        init = Pose3(carry.prev_delta.rotation.expand(K, 4), carry.prev_delta.translation.expand(K, 3))
    else:
        init = Pose3.identity(dtype, (K,), dev)
    rel, det = register_features_batch(feats, tgt, init, reg_params)
    # world_T_frame_j = carry.world o rel_0 o ... o rel_j
    cum = pose_cumcompose(rel)
    world = Pose3(carry.world.rotation.expand(K, 4), carry.world.translation.expand(K, 3)).compose(cum)
    last = lambda x: x[-1]
    new_carry = StreamCarry(
        prev_feats=feats.map(last),
        prev_delta=tree_map(last, rel),
        world=tree_map(last, world).normalize(),
    )
    return new_carry, world, det


def _prep_frame(frame, packed: bool, cfg) -> np.ndarray:
    """One source frame as the host array that is uploaded: the float32
    grid, or the packed planes (uint8 planes pass through, a grid is encoded
    on the host). A uint8 frame on the unpacked path is refused: cast to
    float it would be taken for a grid of coordinates."""
    frame = np.asarray(frame)
    if not packed:
        if frame.dtype == np.uint8:
            raise ValueError(
                "a uint8 frame is packed planes: pass packed=True, or decode it "
                "(io.packed.decode_packed) before pushing it with packed=False")
        return frame.astype(np.float32, copy=False)
    if frame.dtype == np.uint8:
        return frame
    return encode_packed_grid(frame, cfg[0], cfg[1], cfg[2])


def _upload(frames: List[np.ndarray], device: torch.device) -> torch.Tensor:
    """The chunk's frames stacked on ``device``. For a GPU they are stacked
    in a pinned host buffer and copied without blocking the host; the buffer
    goes back to PyTorch's pinned allocator, which keeps it until the copy
    has run."""
    if device.type != "cuda":
        return torch.from_numpy(np.stack(frames)).to(device)
    host = torch.empty((len(frames),) + frames[0].shape, dtype=torch.from_numpy(frames[0]).dtype,
                       pin_memory=True)
    np.stack(frames, out=host.numpy())
    return host.to(device, non_blocking=True)


class _ChunkRunner:
    """The chunk loop shared by :func:`odometry_streaming` and
    :class:`StreamingOdometry`: buffers prepared frames, and when K are there
    uploads them and runs the chunk step, keeping the results on the device."""

    def __init__(self, lidar, feat_params, reg_params, chunk_frames, packed, motion_init,
                 elev_lo, elev_hi, dewarp, device):
        self.K = int(chunk_frames)
        if self.K < 1:
            raise ValueError(f"chunk_frames must be at least 1, got {chunk_frames}")
        self.packed = packed
        self.cfg = (elev_lo, elev_hi, PACKED_R_MAX) if packed else None
        self.device = resolve(device)
        self._args = (lidar, feat_params, reg_params, self.cfg, motion_init, dewarp)
        self.carry = stream_init(lidar, feat_params, device=self.device)
        self.buf: List[np.ndarray] = []
        self.n_frames = 0

    def add(self, frame) -> Optional[Tuple[Pose3, RegistrationDetail]]:
        """Buffer one frame; the chunk's (world, detail) if it filled one."""
        self.buf.append(_prep_frame(frame, self.packed, self.cfg))
        self.n_frames += 1
        return self._run() if len(self.buf) == self.K else None

    def flush(self) -> Optional[Tuple[int, Pose3, RegistrationDetail]]:
        """Run the buffered tail, filled up with copies of its last frame:
        (real frames, world, detail), or None if nothing is buffered."""
        if not self.buf:
            return None
        n_real = len(self.buf)
        self.buf.extend([self.buf[-1]] * (self.K - n_real))
        return (n_real,) + self._run()

    def _run(self):
        chunk = _upload(self.buf, self.device)
        self.buf.clear()
        self.carry, world, det = stream_chunk_step(self.carry, chunk, *self._args)
        return world, det


class StreamingOdometry:
    """Incremental push API over the chunked backend.

    The reference's usage model is a pull loop the user writes
    (``README.md:44-60``); :func:`odometry_streaming` covers its offline form.
    This class covers the live form, a sensor callback pushing scans one at a
    time, with the same chunked execution underneath:

        odo = StreamingOdometry(lidar, chunk_frames=8)
        for scan in sensor:              # (L, P, 3) grids or packed planes
            for frame_idx, pose in odo.push(scan):
                ...                      # world poses as chunks complete
        for frame_idx, pose in odo.finish():
            ...

    ``push`` buffers until a chunk fills, then enqueues its upload and compute
    and returns the completed poses it can hand out without waiting for the
    chunk just enqueued (that chunk's results come with a later ``push`` or
    ``finish``: one chunk of latency buys the overlap). ``finish`` fills up
    and flushes the tail. Poses are ``Pose3`` of CPU tensors with their global
    frame index. It runs on the card unless ``device`` says otherwise
    (``device.py``).
    """

    def __init__(
        self,
        lidar: LidarParams,
        feat_params: FeatureExtractionParams = FeatureExtractionParams(),
        reg_params: RegistrationParams = RegistrationParams(),
        chunk_frames: int = 8,
        packed: bool = True,
        motion_init: bool = True,
        elev_lo: float = -0.30,
        elev_hi: float = 0.25,
        dewarp: bool = False,
        device=None,
    ):
        self._runner = _ChunkRunner(lidar, feat_params, reg_params, chunk_frames, packed,
                                    motion_init, elev_lo, elev_hi, dewarp, device)
        self._pending: list = []  # [(start_frame, n_real, world)]
        self._done = False

    def _drain(self, block: bool) -> list:
        out = []
        # hand out every chunk except the newest (still in flight) unless
        # blocking; reading a result waits for its chunk
        keep = 0 if block else 1
        while len(self._pending) > keep:
            start, n_real, world = self._pending.pop(0)
            t = world.translation[:n_real].cpu()
            q = world.rotation[:n_real].cpu()
            out.extend((start + j, Pose3(q[j], t[j])) for j in range(n_real))
        return out

    def push(self, scan) -> list:
        """Feed one scan; returns [(frame_index, world_T_frame), ...] for the
        frames whose chunks have completed (possibly none)."""
        if self._done:
            raise RuntimeError("push() after finish()")
        ran = self._runner.add(scan)
        if ran is not None:
            K = self._runner.K
            self._pending.append((self._runner.n_frames - K, K, ran[0]))
        return self._drain(block=False)

    def finish(self) -> list:
        """Flush the buffered tail (filling up the last chunk) and return the
        remaining poses. The instance cannot be pushed to afterwards."""
        self._done = True
        ran = self._runner.flush()
        if ran is not None:
            n_real, world, _ = ran
            self._pending.append((self._runner.n_frames - n_real, n_real, world))
        return self._drain(block=True)

    @property
    def frames_pushed(self) -> int:
        return self._runner.n_frames


def odometry_streaming(
    source: Union[Sequence[str], np.ndarray, Iterable[np.ndarray]],
    lidar: LidarParams,
    feat_params: FeatureExtractionParams = FeatureExtractionParams(),
    reg_params: RegistrationParams = RegistrationParams(),
    chunk_frames: int = 16,
    packed: bool = True,
    motion_init: bool = True,
    n_threads: int = 4,
    queue_cap: int = 32,
    elev_lo: float = -0.30,
    elev_hi: float = 0.25,
    dewarp: bool = False,
    device=None,
) -> Tuple[Pose3, RegistrationDetail]:
    """Odometry over a stream of frames, IO, upload and compute pipelined.

    Args:
      source: a list of ``.bin``/``.pcd`` paths (read and projected ahead by
        the native prefetch loader, ``io.native.ScanLoader``), a stacked
        (F, L, P, 3) array, or any iterable of per-frame grids or (4, L, P)
        uint8 packed planes (numpy arrays or CPU tensors).
      chunk_frames: frames per upload and compute quantum. Larger chunks
        spread the per-chunk launches over more frames; smaller chunks
        overlap host and device more finely and answer sooner.
      packed: ship the scans in the 4-byte/point format (a third of the
        upload bytes, quantization below sensor noise, see ``io/packed.py``).
        For path sources the loader packs in its worker threads; grids are
        packed on the host thread.
      n_threads / queue_cap: the loader's worker threads and the frames it
        may hold ready (path sources only).
      elev_lo / elev_hi: the sensor's vertical field of view (rad), used both
        by the file projection and by the packed codec's per-row elevation
        cells. They MUST match the
        geometry of the data: the codec quantizes elevation offsets against
        these rows, so a wrong field of view snaps points into wrong cells
        (meters of error at range) instead of raising. The defaults match the
        synthetic renderer.
      device: where it runs; ``None`` is the card (``device.py``).

    Returns:
      (trajectory, details): trajectory is (F,) world poses with frame 0 at
      identity; details has (F-1,) leaves for the pairs (i-1, i), as
      ``odometry_offline`` returns them. Both stay on the device.
    """
    runner = _ChunkRunner(lidar, feat_params, reg_params, chunk_frames, packed, motion_init,
                          elev_lo, elev_hi, dewarp, device)
    loader = None
    if isinstance(source, (list, tuple)) and source and isinstance(source[0], (str, os.PathLike)):
        loader = ScanLoader([os.fspath(p) for p in source], lidar.scan_lines,
                            lidar.points_per_line, elev_lo, elev_hi, n_threads=n_threads,
                            queue_cap=queue_cap, packed=packed)
        frames = loader
    else:
        frames = np.asarray(source) if hasattr(source, "shape") else source
    worlds, dets = [], []
    try:
        for frame in frames:
            ran = runner.add(frame)
            if ran is not None:
                worlds.append(ran[0])
                dets.append(ran[1])
    finally:
        if loader is not None:
            loader.close()
    ran = runner.flush()
    if ran is not None:
        worlds.append(ran[1])
        dets.append(ran[2])
    if runner.n_frames == 0:
        raise ValueError("odometry_streaming: empty source")
    cat = lambda xs: tree_map(lambda *ls: torch.cat(ls)[: runner.n_frames], *xs)
    trajectory = cat(worlds)
    details = tree_map(lambda x: x[1:], cat(dets))  # drop the first frame's dummy pair
    return trajectory, details
