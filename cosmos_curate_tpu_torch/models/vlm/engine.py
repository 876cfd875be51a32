"""Continuous-batching caption engine (port of
``cosmos_curate_tpu/models/vlm/engine.py``).

The host scheduler is the reference's, copied as it stands: paged KV block
pool with per-slot block tables, short/long decode lanes, batched and
chunked prefill (with the shift-back final chunk), the refcounted
shared-prefix LRU with copy-on-write tails, owner fairness across callers,
and the ``async_prep`` thread that overlaps vision encode with decode.

The reference's jitted device programs become torch methods that update the
KV pools IN PLACE. In the default ``paged_attention="auto"`` mode, every
prefill group, prefill chunk and decode step runs ``VLM.paged_forward``,
whose attention is the hand-written paged kernels on the GPU
(ops/paged_attention.py); shared-prefix builds run the contiguous forward,
whose T > 1 attention is the contiguous prefill kernel
(ops/prefill_attention.py). ``paged_attention="gather"`` runs the
gather-view / scatter-back programs: each step copies the rows' blocks into
contiguous caches and runs the contiguous forward, whose attention is the
prefill kernel for T > 1 and the decode kernel (ops/decode_attention.py)
for T = 1 on the GPU. On the CPU both families run the plain versions and
give bit-equal tokens, which makes gather the paged path's parity reference.

A ``qwen3`` model's deepstack levels ride with each multimodal request
(``ds``, zeros at text positions, None for text-only requests) through the
vision-feature cache, prep, the prefix fold-in, the tail cut and the
per-bucket and per-chunk buffers into every prefill; decode and
shared-prefix builds pass None. Rows reach the model exactly as the JAX
engine shapes them (bucket padding, row 0 duplicated into padding rows,
idle decode rows), which the MoE's expert capacity makes part of the result.

The engine runs on ``device="cuda"`` unless the caller passes
``device="cpu"``; it never moves to the CPU on its own. Not ported in this
slice: tensor-parallel serving (``mesh``).
"""

from __future__ import annotations

import math
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from cosmos_curate_tpu_torch.core.model import model_device
from cosmos_curate_tpu_torch.models.batching import next_pow2
from cosmos_curate_tpu_torch.models.tokenizer import ByteTokenizer, default_caption_tokenizer
from cosmos_curate_tpu_torch.models.vlm.model import VLM, VLMConfig, build_mrope_positions, init_cache
from cosmos_curate_tpu_torch.models.vlm.paged_kv import (
    BlockAllocator,
    PoolExhausted,
    gather_block_views,
    init_block_pool,
    scatter_block_views,
)

# full sampling surface (top_p/min_p/penalties/min_tokens) lives in
# models/vlm/sampling.py; re-exported here for the existing import paths
from cosmos_curate_tpu_torch.models.vlm.sampling import SamplingConfig, sample_token
from cosmos_curate_tpu_torch.ops._build import DEVICE_FAULTS
from cosmos_curate_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# The scheduler drops a request whose prep, claim or prefill raises, but a
# device fault is never one request's fault (every later request would fail
# the same way): it propagates to the caller of step() /
# run_until_complete().
_DEVICE_FAULTS = DEVICE_FAULTS


@dataclass
class CaptionRequest:
    request_id: str
    prompt_ids: list[int]
    frames: np.ndarray | None = None  # uint8 [N, H, W, 3]
    # rate the frames were sampled at (frames/sec of source time); drives
    # Qwen2.5-VL's absolute-time temporal m-rope (None = unscaled)
    frame_fps: float | None = None
    # text tokens embedded BEFORE the vision block (chat templates put the
    # system turn + <|vision_start|> ahead of the image pads); prompt_ids
    # follow the vision block
    prefix_ids: list[int] = field(default_factory=list)
    sampling: SamplingConfig = field(default_factory=SamplingConfig)
    # called with the finished text; may return a follow-up request
    # (two-stage caption refinement, reference vllm_interface.py:543)
    on_complete: Callable[[str], "CaptionRequest | None"] | None = None
    metadata: dict[str, Any] = field(default_factory=dict)
    # set by add_request: which caller's run_until_complete owns this request
    # (several caption-family stages share one engine; see run_until_complete)
    owner: Any = None
    # Whether this request's text prefix may be served from / inserted into
    # the shared-prefix KV cache. Stages set False for one-shot prefixes
    # (the refinement pass bakes the stage-1 caption into its prefix, so
    # caching it would only thrash the LRU).
    share_prefix: bool = True
    # Encoded vision-tower output reused across passes of the SAME frames
    # (the engine fills this after the first encode; a refinement follow-up
    # carrying the identical frames array inherits it automatically).
    vision_features: Any = field(default=None, repr=False)


@dataclass
class _Slot:
    request: CaptionRequest
    position: int  # next cache position to write (== current length)
    # next ROPE position — under m-rope this lags the cache position
    # (vision tokens share t/h/w coordinates; text resumes at max(grid)+1)
    rope_position: int = 0
    generated: list[int] = field(default_factory=list)
    # per-request generator when sampling.seed is set (reproducible
    # captions regardless of batch interleaving); None = engine-shared rng
    rng: np.random.Generator | None = None
    # incrementally decoded output bytes (exact: decode is per-token byte
    # concatenation) — stop-string checks scan a bounded tail of this
    raw: bytearray = field(default_factory=bytearray)
    # prompt+output token counts maintained incrementally for penalties
    # (None when no penalty is configured)
    penalty_counts: dict[int, int] | None = None


def _truncate_at_stop(text: str, stops: tuple[str, ...]) -> str | None:
    """Text before the EARLIEST stop-string match (tuple order must not
    matter), or None when nothing matches."""
    idx = min((i for i in (text.find(s) for s in stops) if i >= 0), default=-1)
    return text[:idx] if idx >= 0 else None


@dataclass
class CaptionResult:
    request_id: str
    text: str
    num_prompt_tokens: int
    num_output_tokens: int
    metadata: dict[str, Any] = field(default_factory=dict)
    owner: Any = None


@dataclass
class _VisionFeatures:
    """One window's encoded vision-tower output, cached on the request so a
    refinement follow-up over the SAME frames skips the tower entirely."""

    embeds: Any  # [T_vis, D] device tensor
    ds: np.ndarray | None  # qwen3 deepstack levels [L_ds, T_vis, D]
    grid: tuple[int, int, int] | None
    eff_fps: float | None
    n_tokens: int


@dataclass
class _Prepared:
    """A request after host/vision prep, ready for admission.

    ``embeds`` hold only the SUFFIX (everything after the shared text
    prefix) when ``base > 0``: the prefix's K/V come from the shared-prefix
    cache and are device-copied into the slot's cache rows at admission, so
    prefill starts at cache position ``base`` (rope positions stay
    absolute — ``rope`` rows are the suffix slice of the full layout)."""

    request: CaptionRequest
    embeds: np.ndarray  # [T_suffix, D] float32
    t_suffix: int
    rope: np.ndarray  # [T_suffix] or [T_suffix, 3]
    next_rope: int
    ds: np.ndarray | None = None  # [L_ds, T_suffix, D] deepstack (suffix-aligned)
    base: int = 0  # cached prefix length already in the KV cache
    prefix_key: tuple | None = None

    @property
    def total(self) -> int:
        return self.base + self.t_suffix


@dataclass
class _PrefixEntry:
    """One shared text prefix, prefilled ONCE and resident in pool blocks.

    Admitted requests reference ``blocks[:n_full]`` directly through their
    block tables (refcounted — zero device copies); a partially-filled
    ``tail_block`` (``length % block_size != 0``) is copy-on-write
    duplicated at admission, since the referencing slot's own K/V writes
    would otherwise extend into shared memory."""

    blocks: list[int]  # ceil(length / block_size) pool block ids
    n_full: int  # length // block_size — the directly-shareable prefix
    tail_block: int | None  # blocks[-1] when partially filled, else None
    length: int


@dataclass
class _BlockClaim:
    """The pool blocks one admitted slot holds: ``shared`` prefix blocks it
    incref'd (freed back to the prefix entry's refcount on release) and
    ``private`` blocks it owns outright (freed on release)."""

    shared: list[int]
    private: list[int]

    @property
    def all_blocks(self) -> list[int]:
        return self.shared + self.private


@dataclass
class _PendingPrefill:
    """A slot whose prompt is being prefilled chunk by chunk.

    Long prompts are admitted in fixed-size chunks interleaved with decode
    steps (vLLM chunked prefill, reference models/vllm_interface.py:543 +
    SPEED_OF_LIGHT.md:116-121): one prefill group no longer stalls every
    in-flight request's decode for its whole duration. A chunk runs the
    same program as bucket prefill ([N, C, D] rows with a per-row
    write_index)."""

    request: CaptionRequest
    embeds: np.ndarray  # [T, D] prompt embeds (suffix-only when base > 0)
    t_valid: int
    rope_pos: np.ndarray  # [T] or [T, 3]
    next_rope: int
    # qwen3 deepstack visual features [L_ds, T, D] (zeros at text
    # positions), chunk-sliced alongside embeds; None otherwise
    ds: np.ndarray | None = None
    progress: int = 0  # prompt tokens already written to the cache
    # cache offset where this prompt's writes start (= cached shared-prefix
    # length; chunk k writes at base + progress)
    base: int = 0


@dataclass
class _Lane:
    """One decode-batch shape: ``n_slots`` block tables of ``length``
    gathered positions each.

    With the paged pool, a lane no longer OWNS KV memory — blocks come from
    the engine-wide pool and occupancy is the admission limit. What a lane
    still bounds is the decode batch: its slots decode as one
    ``[n_slots, length]`` batch, and ``length`` caps the table (so short
    requests attend over short tables instead of the worst case). ``table``
    rows are the slot block tables; free/unused entries point at the
    reserved garbage block 0."""

    length: int
    base: int  # global slot-id offset (lane-local idx + base = public id)
    n_slots: int
    # [n_slots, length // block_size] int32 pool block ids (host-side; a
    # snapshot rides into every prefill/decode program call)
    table: np.ndarray | None = None
    slots: dict = field(default_factory=dict)
    pending: dict = field(default_factory=dict)
    # slot indices claimed by _admit's current grouping pass (released when
    # the group prefill runs)
    reserved: set = field(default_factory=set)
    # slot idx -> _BlockClaim, held from admission until release
    claims: dict = field(default_factory=dict)


class CaptionEngine:
    def __init__(
        self,
        cfg: VLMConfig,
        *,
        max_batch: int = 8,
        params: Any = None,
        tokenizer: ByteTokenizer | None = None,
        prefill_chunk: int = 256,
        kv_lanes: tuple[tuple[int, int], ...] | None = None,
        async_prep: bool = False,
        enable_prefix_cache: bool = True,
        prefix_cache_size: int = 8,
        min_prefix_len: int = 4,
        admission_linger_s: float = 0.05,
        block_size: int = 16,
        kv_pool_blocks: int | None = None,
        owner_inflight_cap: int | None = None,
        paged_attention: str = "auto",
        mesh: Any = None,
        device: str | torch.device = "cuda",
    ) -> None:
        """``params``: a ``state_dict`` of :class:`VLM` (e.g. from
        ``models/convert_jax.py``), or None to initialise from ``setup``'s
        seed. ``device``: where the model and the KV pool live; "cuda"
        unless the caller asks for the CPU."""
        self.device = model_device(device, "CaptionEngine")
        if mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving (mesh) is not ported yet (ROADMAP queue A item 7)"
            )
        self.cfg = cfg
        # qwen3 deepstack: the number of LM layers that take visual features
        self._ds_levels = len(cfg.qwen_vision.deepstack_indexes) if cfg.vision_variant == "qwen3" else 0
        self.max_batch = max_batch
        # prompts longer than this prefill in chunks of this size,
        # interleaved with decode steps
        self.prefill_chunk = min(prefill_chunk, cfg.max_seq)
        self.tokenizer = tokenizer or default_caption_tokenizer()
        # "auto" runs the paged programs: attention reads the pool through
        # the block table (the CUDA kernels on the GPU, their plain versions
        # on the CPU). "gather" runs the gather-view/scatter-back programs
        # over contiguous caches (the contiguous prefill and decode kernels
        # on the GPU).
        if paged_attention not in ("auto", "gather"):
            raise ValueError(f"paged_attention must be auto|gather, got {paged_attention!r}")
        self.paged_attention = paged_attention
        self._use_paged = paged_attention == "auto"
        self.model: VLM | None = None  # built by setup() on self.device
        self.params = params
        self.waiting: list[CaptionRequest] = []
        # (length, n_slots) per decode-batch lane; default = one
        # worst-case-length lane
        spec = kv_lanes or ((cfg.max_seq, max_batch),)
        # every lane length must tile into whole blocks (the gathered view
        # must equal the lane length EXACTLY for shape parity with the
        # slot-row programs): shrink the block size to the largest common
        # divisor when a lane length doesn't tile
        bs = max(1, int(block_size))
        for length, _ in spec:
            bs = math.gcd(bs, int(length))
        if bs != block_size:
            logger.warning(
                "block_size %d does not divide every KV lane length; using %d",
                block_size, bs,
            )
        self.block_size = bs
        base = 0
        self.lanes: list[_Lane] = []
        for length, n in sorted(spec):
            if length > cfg.max_seq:
                raise ValueError(f"lane length {length} exceeds max_seq {cfg.max_seq}")
            self.lanes.append(
                _Lane(
                    length=length,
                    base=base,
                    n_slots=n,
                    table=np.zeros((n, length // bs), np.int32),
                )
            )
            base += n
        self.prefix_cache_size = prefix_cache_size
        lane_blocks = sum((l.length // bs) * l.n_slots for l in self.lanes)
        if kv_pool_blocks is None:
            # pool capacity = the memory the per-lane rows used to pin, plus
            # headroom for the shared-prefix entries that now live in pool
            # blocks, plus the reserved garbage block 0
            prefix_reserve = (
                prefix_cache_size * max(1, min(256, self.lanes[-1].length) // bs)
                if enable_prefix_cache
                else 0
            )
            kv_pool_blocks = 1 + lane_blocks + prefix_reserve
        # a pool smaller than the lane sum could deadlock a full slot load
        self.kv_pool_blocks = max(int(kv_pool_blocks), 1 + lane_blocks)
        self._allocator = BlockAllocator(self.kv_pool_blocks)
        self._pool_k = None
        self._pool_v = None
        self.completed: list[CaptionResult] = []
        self._decode_tokens = 0
        self._decode_time = 0.0
        # dead-work accounting: every decode step runs a lane's FULL slot
        # batch (static shapes); rows without an active slot are wasted.
        # utilization = tokens produced / rows executed
        self._decode_rows = 0
        # per-phase accounting (seconds): host+vision prep, vision-tower
        # share of prep, prefill programs (incl. shared-prefix builds),
        # decode is _decode_time above (phase_seconds / stats()).
        # _stats_lock guards every counter '+=': the prep thread (prep /
        # vision / prefix-build counters) and the step thread (prefill /
        # decode counters) would otherwise lose updates racing on the same
        # attributes.
        #
        # LOCK ORDER:
        #   _lock (== _work_cv)  ->  _prefix_lock  ->  _stats_lock
        # _stats_lock is innermost and leaf-only: never acquire any other
        # engine lock while holding it.
        self._stats_lock = threading.Lock()
        self._prep_time = 0.0
        self._vision_time = 0.0
        self._prefill_time = 0.0
        self._prefill_tokens = 0  # prompt tokens pushed through prefill
        self._vision_encodes = 0
        self._vision_reuses = 0
        # shared-prefix KV cache: LRU over prefix token tuples. Entries are
        # small ([L, Tp, Hkv, Dh] per prefix) next to the lane caches.
        self.enable_prefix_cache = enable_prefix_cache
        self.prefix_cache_size = prefix_cache_size
        self.min_prefix_len = min_prefix_len
        self._prefix_cache: "OrderedDict[tuple, _PrefixEntry]" = OrderedDict()  # guarded-by: _prefix_lock
        # Middle of the canonical order: taken AFTER _lock (engine mutation)
        # and BEFORE _stats_lock, never the other way around — see the order
        # note at _stats_lock above.
        self._prefix_lock = threading.Lock()
        self._prefix_hits = 0
        self._prefix_misses = 0
        self._prefix_evictions = 0
        self._prefix_tokens_saved = 0
        # paged-KV accounting (all under _stats_lock): cumulative block
        # reservations per admitted request (kv_bytes_reserved_per_request),
        # the worst-case tokens a slot-row engine would have reserved for
        # the same admissions, shared-prefix block references handed out,
        # and copy-on-write tail duplications
        self._requests_admitted = 0
        self._kv_blocks_reserved = 0
        self._kv_private_blocks = 0
        self._kv_worstcase_tokens = 0
        self._prefix_block_refs = 0
        self._kv_cow_copies = 0
        self._kv_blocks_used_peak = 0
        # decode steps served by the paged programs (under _stats_lock):
        # structurally 0 in gather mode
        self._paged_kernel_steps = 0
        # cross-job fairness: least-recently-admitted owner goes first, and
        # no owner may hold more than its in-flight share of the slots
        # (owner_inflight_cap; None = ceil(total slots / active owners))
        self.owner_inflight_cap = owner_inflight_cap
        self._owner_last_admit: dict[Any, int] = {}
        self._owner_last_prep: dict[Any, int] = {}
        self._admit_seq = 0
        self._prep_seq = 0
        self._interleaved_steps = 0
        self._owner_decode_tokens: dict[Any, int] = {}
        self._owner_requests: dict[Any, int] = {}
        # async prep: a background thread runs vision encode + embedding for
        # waiting requests while the caller's step() loop decodes — prep of
        # request N+1 overlaps decode of request N (the caption stage's
        # prep/decode stall was ~70% of its engine budget). Sync mode
        # (default) preps inline at admission: deterministic step()
        # semantics for tests.
        self.async_prep = async_prep
        self._ready: "deque[_Prepared]" = deque()
        self._prep_inflight: CaptionRequest | None = None
        self._prep_thread: threading.Thread | None = None
        self._prep_stop = False
        # the first device fault a step or the prep thread hit, re-raised
        # by every later step() / run_until_complete() of any caller
        self._device_fault: BaseException | None = None
        # admission linger: when EVERY lane is idle and a burst is still
        # prepping, opening a lane for the first ready request decodes it
        # solo (full-batch rows for one token). Hold admission up to this
        # long so fast preps pack a batch; slow preps (vision-heavy real
        # configs) blow the deadline and overlap decode instead.
        self.admission_linger_s = admission_linger_s
        self._linger_until: float | None = None
        self._built = False
        # One engine is shared by every caption-family stage in a pipeline
        # (weights + KV cache are too big to duplicate). Stages run in
        # separate pool threads, and prefill/decode update the KV pool in
        # place — concurrent steps would interleave writes. This
        # lock serializes all engine mutation; completions are owner-tagged
        # so one stage's run cannot steal another stage's results.
        # OUTERMOST in the canonical order (_lock -> _prefix_lock ->
        # _stats_lock): always acquired first, via `with self._lock` or its
        # condition alias `with self._work_cv`.
        self._lock = threading.RLock()
        # signaled when prep lands a ready request / a follow-up is queued;
        # run_until_complete waits on it instead of spinning when the only
        # outstanding work is an in-flight background prep
        self._work_cv = threading.Condition(self._lock)

    # read-only aggregate views over the lanes (public slot id = lane.base
    # + lane-local index, unique across lanes)
    @property
    def slots(self) -> dict[int, _Slot]:
        return {l.base + i: s for l in self.lanes for i, s in l.slots.items()}

    @property
    def pending(self) -> dict[int, _PendingPrefill]:
        return {l.base + i: p for l in self.lanes for i, p in l.pending.items()}

    def kv_bytes(self) -> int:
        """Total device bytes the KV block pool pins."""
        if self._pool_k is None:
            return 0
        return self._pool_k.nbytes + self._pool_v.nbytes

    # -- setup ----------------------------------------------------------
    def setup(self, seed: int = 0) -> None:
        """Build the model on ``self.device`` (bridged ``params`` or a seeded
        init) and allocate the KV block pool."""
        cfg = self.cfg
        with torch.device(self.device):
            model = VLM(cfg)
        if self.params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            model.init_weights(gen)
        else:
            model.load_state_dict(self.params, strict=True)
        self.model = model.eval().requires_grad_(False)
        self._pool_k, self._pool_v = init_block_pool(
            cfg, self.kv_pool_blocks, self.block_size, device=self.device
        )
        self._host_rng = np.random.default_rng(seed)
        self._built = True
        if self.async_prep:
            # requests may already be waiting (queued before setup)
            with self._work_cv:
                self._start_prep_thread()
                self._work_cv.notify_all()

    def load_weights(self, state_dict: dict[str, torch.Tensor]) -> None:
        """Serve ``state_dict`` from now on: copy it into the model that
        ``setup`` built (strict: every parameter must match). For weights
        that arrive after setup, as the shared engine's loader's do; call
        it before any request is queued."""
        if self.model is None:
            raise RuntimeError("load_weights() before setup()")
        self.model.load_state_dict(state_dict, strict=True)

    # -- device programs (the reference's jitted functions) -------------
    def _sync(self) -> None:
        """Wait for this thread's queued device work (timing boundaries)."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _to_device(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(arr)).to(self.device)

    def _rope_rows(self, rope_positions: torch.Tensor) -> torch.Tensor:
        """Decode rope positions [N] -> [N, 1] (or [N, 1, 3] under m-rope:
        decode is always text, all three components equal)."""
        rp = rope_positions[:, None]
        if self.cfg.mrope_section is not None:
            rp = rp[..., None].expand(*rp.shape, 3)
        return rp

    @torch.inference_mode()
    def _encode_images(self, frames_u8: np.ndarray):
        """uint8 [1, N, H, W, 3] -> [1, T_vis, D] LM embeddings (qwen3:
        with its deepstack levels [L_ds, 1, T_vis, D], as a pair)."""
        return self.model.encode_images(self._to_device(frames_u8))

    @torch.inference_mode()
    def _embed_tokens(self, ids) -> torch.Tensor:
        """Token ids -> [T, D] embeddings (compute dtype, on device)."""
        return self.model.embed_tokens(self._to_device(np.asarray(ids, np.int32)))

    @torch.inference_mode()
    def _prefill_batch(self, tables, embeds, write_index, t_valid, rope_pos, ds=None) -> torch.Tensor:
        """Batched prefill through the block tables. embeds: [N, Tb, D]
        (bucket- or chunk-padded); tables: [N, nbl]; write_index/t_valid:
        [N]; rope_pos: [N, Tb] (or [N, Tb, 3]); ds: None or the deepstack
        levels [L_ds, N, Tb, D]. write_index > 0 rows are
        later chunks of a chunked prefill, or shared-prefix suffixes
        starting past their cached blocks. Writes every row's K/V into the
        pool and returns each row's logits at its last valid position,
        [N, V] on device.

        Paged mode attends straight out of the pool (``paged_forward``);
        gather mode copies each row's blocks into a contiguous view, runs
        the slot-row forward, and scatters the view back."""
        tables = self._to_device(tables)
        embeds = self._to_device(embeds)
        write_index = self._to_device(write_index)
        t_valid = self._to_device(t_valid)
        rope_pos = self._to_device(rope_pos)
        ds = None if ds is None else self._to_device(ds)
        kv_len = write_index + t_valid
        if self._use_paged:
            logits, _, _ = self.model.paged_forward(
                embeds, self._pool_k, self._pool_v, rope_pos, write_index, kv_len, tables, deepstack=ds
            )
        else:
            ck, cv = gather_block_views(self._pool_k, self._pool_v, tables)
            logits, ck, cv = self.model(embeds, ck, cv, rope_pos, write_index, kv_len, deepstack=ds)
            scatter_block_views(self._pool_k, self._pool_v, tables, ck, cv)
        rows = torch.arange(logits.shape[0], device=self.device)
        return logits[rows, (t_valid - 1).long()]

    @torch.inference_mode()
    def _decode(self, tables, tokens, positions, rope_positions) -> tuple[np.ndarray, torch.Tensor]:
        """One token per slot. tables: [n_slots, nbl] (idle rows point at
        the garbage block); positions index the cache; rope_positions are
        the rotary positions. Returns (greedy ids on the host — the argmax
        runs on device for the whole batch — and the step logits [N, V] on
        device, fetched only when a row samples on the host)."""
        tables = self._to_device(tables)
        positions = self._to_device(positions)
        embeds = self.model.embed_tokens(self._to_device(tokens)[:, None])
        rp = self._rope_rows(self._to_device(rope_positions))
        kv_len = positions + 1
        if self._use_paged:
            logits, _, _ = self.model.paged_forward(
                embeds, self._pool_k, self._pool_v, rp, positions, kv_len, tables
            )
        else:
            ck, cv = gather_block_views(self._pool_k, self._pool_v, tables)
            logits, ck, cv = self.model(embeds, ck, cv, rp, positions, kv_len)
            scatter_block_views(self._pool_k, self._pool_v, tables, ck, cv)
        step_logits = logits[:, 0]
        greedy = torch.argmax(step_logits, dim=-1)
        return greedy.cpu().numpy(), step_logits

    @torch.inference_mode()
    def _prefix_prefill(self, embeds, rope_pos, t_valid: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Prefill ONE text prefix into a scratch contiguous cache and return
        its K/V [L, Sp, Hkv, Dh]. embeds: [1, Sp, D] (pow2-padded). Runs
        once per prefix (per flavor and prompt variant), not per request."""
        embeds = self._to_device(embeds)
        ck, cv = init_cache(self.cfg, 1, length=embeds.shape[1], device=self.device)
        zero = torch.zeros((1,), dtype=torch.int32, device=self.device)
        kv_len = torch.full((1,), t_valid, dtype=torch.int32, device=self.device)
        _, ck, cv = self.model(embeds, ck, cv, self._to_device(rope_pos), zero, kv_len)
        return ck[:, 0], cv[:, 0]

    @torch.inference_mode()
    def _write_prefix_blocks(self, pk, pv, ids: list[int]) -> None:
        """Store one freshly built prefix K/V ([L, Tp, Hkv, Dh]) into its
        allocated pool blocks ``ids`` — the ONE device write per prefix
        build; admitted requests then reference these blocks."""
        bs = self.block_size
        idx = torch.as_tensor(ids, dtype=torch.long, device=self.device)
        for pool, x in ((self._pool_k, pk), (self._pool_v, pv)):
            pad = len(ids) * bs - x.shape[1]
            x = torch.nn.functional.pad(x.to(pool.dtype), (0, 0, 0, 0, 0, pad))
            pool[:, idx] = x.reshape(x.shape[0], len(ids), bs, *x.shape[2:])

    @torch.inference_mode()
    def _copy_blocks(self, src: list[int], dst: list[int]) -> None:
        """Copy-on-write: duplicate pool blocks ``src`` into ``dst`` — used
        ONLY when a request must extend a partially-filled shared prefix
        tail block (one block, not the whole prefix)."""
        s = torch.as_tensor(src, dtype=torch.long, device=self.device)
        d = torch.as_tensor(dst, dtype=torch.long, device=self.device)
        for pool in (self._pool_k, self._pool_v):
            pool[:, d] = pool[:, s]

    # -- public API -----------------------------------------------------
    @property
    def _max_len(self) -> int:
        return self.lanes[-1].length  # lanes are sorted by length

    def add_request(self, request: CaptionRequest, owner: Any = None) -> None:
        budget = self._max_len - request.sampling.max_new_tokens - 1
        if budget <= 0:
            raise ValueError(
                f"max_new_tokens={request.sampling.max_new_tokens} leaves no "
                f"prompt budget in the longest KV lane ({self._max_len})"
            )
        if any(not s for s in request.sampling.stop):
            # '' in tail is always True — an empty stop string would finish
            # the request after one token with empty text
            raise ValueError("stop strings must be non-empty")
        if request.owner is None:
            request.owner = owner if owner is not None else threading.get_ident()
        with self._work_cv:
            self.waiting.append(request)
            # only a BUILT engine may prep (the thread calls the model
            # setup() creates); requests queued before setup()
            # wait — setup() starts the thread for them, and the sync
            # step() path keeps raising 'call setup() first'
            if self.async_prep and self._built:
                self._start_prep_thread()
            self._work_cv.notify_all()

    def _prep_requests(self) -> list[CaptionRequest]:
        """Requests past ``waiting`` but not yet admitted (prepared or
        mid-prep in the background thread). Lock held by caller."""
        reqs = [p.request for p in self._ready]
        if self._prep_inflight is not None:
            reqs.append(self._prep_inflight)
        return reqs

    def has_work(self, owner: Any = None) -> bool:
        with self._lock:
            if owner is None:
                return bool(
                    self.waiting or self._prep_requests() or self.slots or self.pending
                )
            return (
                any(r.owner == owner for r in self.waiting)
                or any(r.owner == owner for r in self._prep_requests())
                or any(s.request.owner == owner for s in self.slots.values())
                or any(p.request.owner == owner for p in self.pending.values())
            )

    def wait_prep_idle(self, timeout: float) -> bool:
        """Block until no request waits for prep and the prep thread holds
        none; False if ``timeout`` seconds pass first. A caller whose next
        device work must not overlap prep's (a profiled window) calls this
        first. Requests already prepared stay queued for ``step``."""
        with self._work_cv:
            return self._work_cv.wait_for(
                lambda: not self.waiting and self._prep_inflight is None, timeout
            )

    def run_until_complete(self, owner: Any = None) -> list[CaptionResult]:
        """Drive the engine until this caller's requests are done.

        ``owner`` defaults to the calling thread's ident — the same default
        ``add_request`` tags requests with — so the existing
        add-then-run-in-one-thread usage is unchanged. Requests queued by
        other owners still ride along in the continuous batch (free
        throughput), but their completions stay queued for *their*
        ``run_until_complete``.
        """
        if owner is None:
            owner = threading.get_ident()
        while True:
            # Lock per step, not across the drain: another stage's
            # add_request must be able to slip in between decode steps so
            # its requests actually join the continuous batch.
            with self._work_cv:
                self._raise_device_fault()
                if not self.has_work(owner):
                    mine = [r for r in self.completed if r.owner == owner]
                    self.completed = [r for r in self.completed if r.owner != owner]
                    # keep THIS owner's entries: the caller reads its
                    # per-owner accounting deltas right after this returns
                    self._prune_owner_state(keep=owner)
                    return mine
                steppable = (
                    bool(self._ready)
                    or (not self.async_prep and bool(self.waiting))
                    or any(l.slots or l.pending for l in self.lanes)
                )
                if not steppable or self._should_linger():
                    # only background prep is outstanding (or admission is
                    # lingering for the burst's prep to pack a batch) —
                    # sleep until it lands instead of spinning empty steps
                    self._work_cv.wait(0.02)
                    continue
                self.step()

    @property
    def tokens_per_second(self) -> float:
        return self._decode_tokens / self._decode_time if self._decode_time > 0 else 0.0

    @property
    def decode_tokens(self) -> int:
        return self._decode_tokens

    @property
    def decode_time_s(self) -> float:
        return self._decode_time

    @property
    def prefill_tokens(self) -> int:
        """Prompt tokens pushed through prefill programs (bucket, chunk,
        and shared-prefix builds; cache-inserted prefix copies are NOT
        prefill). With the shared-prefix cache, n requests sharing a
        Tp-token prefix prefill Tp fewer tokens each after the first."""
        return self._prefill_tokens

    @property
    def prefix_cache_hits(self) -> int:
        return self._prefix_hits

    @property
    def prefix_cache_misses(self) -> int:
        return self._prefix_misses

    @property
    def prefix_cache_evictions(self) -> int:
        return self._prefix_evictions

    @property
    def prefix_tokens_saved(self) -> int:
        """Prefill tokens NOT recomputed thanks to shared-prefix hits."""
        return self._prefix_tokens_saved

    @property
    def vision_encodes(self) -> int:
        return self._vision_encodes

    @property
    def vision_reuses(self) -> int:
        return self._vision_reuses

    # -- paged-KV occupancy and cross-job accounting --------------------
    @property
    def kv_blocks_total(self) -> int:
        """Allocatable pool blocks (admission limit; garbage block excluded)."""
        return self._allocator.capacity

    @property
    def kv_blocks_used(self) -> int:
        return self._allocator.used_blocks

    @property
    def kv_blocks_used_peak(self) -> int:
        """High-water pool occupancy since the last reset_stats()."""
        return self._kv_blocks_used_peak

    @property
    def kv_block_bytes(self) -> int:
        """Device bytes one block pins (K + V across all layers)."""
        cfg = self.cfg
        # bf16 pool: 2 bytes/element, x2 for K and V
        return 2 * 2 * cfg.n_layers * self.block_size * cfg.n_kv_heads * cfg.head_dim

    @property
    def prefix_block_refs(self) -> int:
        """Cumulative shared-prefix block references handed to admitted
        requests — each one is a whole block of prefix K/V served with ZERO
        device copies."""
        return self._prefix_block_refs

    @property
    def prefix_copy_dispatches(self) -> int:
        """Whole-prefix device-copy dispatches at admission. Structurally
        zero with the paged pool: admitted requests REFERENCE prefix blocks
        through their tables instead of copying them into slot rows."""
        return 0

    @property
    def kv_cow_copies(self) -> int:
        """Copy-on-write duplications of a partially-filled shared prefix
        tail block (ONE block each — not a prefix copy)."""
        return self._kv_cow_copies

    @property
    def paged_kernel_steps(self) -> int:
        """Decode steps served by the paged-attention programs (attention
        read the pool through the block table). Structurally zero under
        ``paged_attention="gather"``."""
        return self._paged_kernel_steps

    def stats(self) -> dict:
        """One-call snapshot of the serving counters."""
        with self._stats_lock:
            return {
                "paged_attention": self.paged_attention,
                "kv_block_size": self.block_size,
                "paged_kernel_steps": self._paged_kernel_steps,
                "decode_tokens": self._decode_tokens,
                "decode_s": self._decode_time,
                "prefill_tokens": self._prefill_tokens,
                "prefill_s": self._prefill_time,
                "kv_blocks_total": self._allocator.capacity,
                "kv_blocks_used": self._allocator.used_blocks,
                "kv_blocks_used_peak": self._kv_blocks_used_peak,
            }

    @property
    def requests_admitted(self) -> int:
        return self._requests_admitted

    @property
    def kv_bytes_reserved_per_request(self) -> float:
        """Mean KV bytes reserved per admitted request (shared references
        counted at full block size — strictly below the lane's worst-case
        row whenever prompt + max_new undershoots the lane)."""
        if not self._requests_admitted:
            return 0.0
        return self._kv_blocks_reserved * self.kv_block_bytes / self._requests_admitted

    @property
    def kv_bytes_worstcase_per_request(self) -> float:
        """What the slot-row engine reserved for the same admissions: each
        routed lane's FULL row, regardless of actual request length."""
        if not self._requests_admitted:
            return 0.0
        token_bytes = self.kv_block_bytes / self.block_size
        return self._kv_worstcase_tokens * token_bytes / self._requests_admitted

    @property
    def interleaved_decode_steps(self) -> int:
        """Steps whose active slots spanned 2+ owners — the cross-job
        continuous-batching signal (two pipelines decoding in ONE batch)."""
        return self._interleaved_steps

    @property
    def owner_decode_tokens(self) -> dict:
        with self._stats_lock:
            return dict(self._owner_decode_tokens)

    def owner_stats(self) -> dict:
        """Per-owner queue/in-flight/served gauges, keyed by str(owner) —
        the cross-job accounting surface."""
        with self._lock:
            out: dict[str, dict] = {}

            def bucket(owner):
                return out.setdefault(
                    str(owner),
                    {"waiting": 0, "ready": 0, "inflight": 0,
                     "decode_tokens": 0, "requests": 0},
                )

            for r in self.waiting:
                bucket(r.owner)["waiting"] += 1
            if self._prep_inflight is not None:
                bucket(self._prep_inflight.owner)["waiting"] += 1
            for p in self._ready:
                bucket(p.request.owner)["ready"] += 1
            for lane in self.lanes:
                for s in lane.slots.values():
                    bucket(s.request.owner)["inflight"] += 1
                for p in lane.pending.values():
                    bucket(p.request.owner)["inflight"] += 1
            with self._stats_lock:
                for owner, n in self._owner_decode_tokens.items():
                    bucket(owner)["decode_tokens"] = n
                for owner, n in self._owner_requests.items():
                    bucket(owner)["requests"] = n
            return out

    @property
    def phase_seconds(self) -> dict[str, float]:
        """Cumulative per-phase seconds: ``prep`` (host prep incl. the
        vision share), ``vision_encode`` (vision-tower subset of prep),
        ``prefill`` (prefill programs + host sync), ``decode`` (decode
        steps + host sync). Wall minus (prefill + decode) over a drive
        window is the engine's idle/stall time."""
        return {
            "prep_s": self._prep_time,
            "vision_encode_s": self._vision_time,
            "prefill_s": self._prefill_time,
            "decode_s": self._decode_time,
        }

    def reset_stats(self) -> None:
        """Zero the throughput counters (e.g. after benchmark warmup) —
        the counter set and its reset stay in one place. Shared-prefix
        cache CONTENTS survive (only the hit/miss counters reset)."""
        with self._stats_lock:
            self._decode_tokens = 0
            self._decode_time = 0.0
            self._decode_rows = 0
            self._prep_time = 0.0
            self._vision_time = 0.0
            self._prefill_time = 0.0
            self._prefill_tokens = 0
            self._vision_encodes = 0
            self._vision_reuses = 0
            self._prefix_hits = 0
            self._prefix_misses = 0
            self._prefix_evictions = 0
            self._prefix_tokens_saved = 0
            self._requests_admitted = 0
            self._kv_blocks_reserved = 0
            self._kv_private_blocks = 0
            self._kv_worstcase_tokens = 0
            self._prefix_block_refs = 0
            self._kv_cow_copies = 0
            self._paged_kernel_steps = 0
            self._kv_blocks_used_peak = self._allocator.used_blocks
            self._interleaved_steps = 0
            self._owner_decode_tokens.clear()
            self._owner_requests.clear()

    def clear_prefix_cache(self) -> None:
        """Drop every cached prefix and release the LRU's block references.
        Blocks still mapped by in-flight slots stay allocated until those
        slots release (deferred free); after a full drain the pool reads
        fully free."""
        with self._lock, self._prefix_lock:
            for entry in self._prefix_cache.values():
                self._allocator.decref(entry.blocks)
            self._prefix_cache.clear()

    def shutdown(self) -> None:
        """Stop the background prep thread and release the prefix cache's
        block references (tests assert the pool is fully free after a
        drained shutdown; long-lived engines just let the daemon thread die
        with the process)."""
        self.clear_prefix_cache()
        with self._work_cv:
            self._prep_stop = True
            self._work_cv.notify_all()
        t = self._prep_thread
        if t is not None:
            t.join(timeout=5)
            if t.is_alive():
                # mid-encode and past the grace: leave the stop flag SET so
                # the thread exits at its next loop check instead of
                # resuming work beside a future replacement thread
                logger.warning("caption prep thread still running after 5s grace")
                return
            self._prep_thread = None
        self._prep_stop = False

    @property
    def decode_slot_utilization(self) -> float:
        """Fraction of executed decode rows that produced a token (the
        static-batch dead-work measure; lanes raise it by keeping batches
        near their occupancy)."""
        return self._decode_tokens / self._decode_rows if self._decode_rows else 0.0

    # -- engine internals ----------------------------------------------
    def step(self) -> None:
        """Admit ready requests, advance chunked prefills, then one decode
        step per active lane — so a long prompt never blocks the in-flight
        batch's decode for more than a chunk's latency.

        Chunk admission is tuned against decode occupancy (the live signal
        behind ``decode_slot_utilization``): chunking exists to protect
        in-flight decode from a long prefill stall, so while NO lane is
        decoding, pending chunks run back to back instead of one per step —
        an idle engine prefills at full speed."""
        if not self._built:
            raise RuntimeError("call setup() first")
        with self._work_cv:
            self._raise_device_fault()
            try:
                self._step()
            except _DEVICE_FAULTS as e:
                # the pool may hold claims of requests that never started:
                # the engine stays failed
                self._device_fault = e
                raise
            self._work_cv.notify_all()  # ready-queue space may have freed

    # holds-lock: _lock
    def _step(self) -> None:
        self._admit()
        # cross-job signal: this step's active slots span 2+ owners —
        # several jobs are decoding in ONE continuous batch
        step_owners = {
            s.request.owner for l in self.lanes for s in l.slots.values()
        }
        if len(step_owners) > 1:
            with self._stats_lock:
                self._interleaved_steps += 1
        for lane in self.lanes:
            if lane.pending:
                self._prefill_chunk_step(lane)
                while lane.pending and not any(l.slots for l in self.lanes):
                    self._prefill_chunk_step(lane)
            if lane.slots:
                self._decode_once(lane)

    def _raise_device_fault(self) -> None:
        """Re-raise the device fault a step or the prep thread hit: after
        one, every step() / run_until_complete() raises it. Lock held by
        caller."""
        if self._device_fault is not None:
            raise self._device_fault

    # -- request prep (sync inline, or the background overlap thread) ---
    def _start_prep_thread(self) -> None:
        if self._prep_thread is not None and self._prep_thread.is_alive():
            return
        # a shutdown() whose join grace expired leaves _prep_stop latched;
        # a fresh thread must not read the stale flag and die instantly
        self._prep_stop = False
        self._prep_thread = threading.Thread(
            target=self._prep_loop, name="caption-prep", daemon=True
        )
        self._prep_thread.start()

    def _prep_ahead_limit(self) -> int:
        # bound host memory for prepared-but-unadmitted embeds: enough to
        # keep every slot fed one wave ahead, no more
        return max(2, 2 * sum(l.n_slots for l in self.lanes))

    def _prep_loop(self) -> None:
        """Background prep: vision encode + token embedding for waiting
        requests, FIFO, overlapping the caller's decode loop. Device
        compute runs OUTSIDE the engine lock — the lock only guards queue
        hops, so a decode step never waits on a vision encode and vice
        versa (device-side serialization is the hardware's business)."""
        while True:
            with self._work_cv:
                while not self._prep_stop and (
                    not self.waiting or len(self._ready) >= self._prep_ahead_limit()
                ):
                    self._work_cv.wait(0.1)
                if self._prep_stop:
                    return
                req = self._pop_waiting_fair()
                self._prep_inflight = req
            try:
                prep = self._safe_prepare(req)  # no lock: overlaps decode
            except _DEVICE_FAULTS as e:
                with self._work_cv:
                    self._prep_inflight = None
                    self._device_fault = e
                    self._work_cv.notify_all()
                return
            with self._work_cv:
                self._prep_inflight = None
                if prep is not None:
                    self._ready.append(prep)
                self._work_cv.notify_all()

    # every stage instance mints a fresh owner tag, so a long-lived shared
    # engine would otherwise accumulate owner-keyed state forever (and mint
    # unbounded per-owner metric series)
    _OWNER_STATE_CAP = 256

    # holds-lock: _lock
    def _prune_owner_state(self, keep: Any = None) -> None:
        """Bound the owner-keyed maps: once past the cap, drop entries for
        owners with no live work. ``keep`` protects the owner whose drive
        just completed — its stage reads the accounting deltas right after
        (pruning it first would hand the stage a zero/negative delta).
        Lock held by caller."""
        maps = (
            self._owner_last_admit,
            self._owner_last_prep,
            self._owner_decode_tokens,
            self._owner_requests,
        )
        if all(len(m) <= self._OWNER_STATE_CAP for m in maps):
            return
        live = {r.owner for r in self.waiting}
        live.update(p.request.owner for p in self._ready)
        if self._prep_inflight is not None:
            live.add(self._prep_inflight.owner)
        for lane in self.lanes:
            live.update(s.request.owner for s in lane.slots.values())
            live.update(p.request.owner for p in lane.pending.values())
        live.update(r.owner for r in self.completed)
        if keep is not None:
            live.add(keep)
        with self._stats_lock:
            for m in maps:
                if len(m) > self._OWNER_STATE_CAP:
                    for owner in [o for o in m if o not in live]:
                        del m[owner]

    @staticmethod
    def _fair_head(owners_in_order, last_map: dict, inflight: dict, cap: float):
        """(owner, index) of the next fair pick: FIFO within an owner,
        least-recently-served owner first, owners at ``cap`` in-flight
        skipped. ``owners_in_order`` yields each queue item's owner in
        queue order. Returns None when every queued owner is capped."""
        heads: "OrderedDict[Any, int]" = OrderedDict()
        for i, owner in enumerate(owners_in_order):
            if owner not in heads:
                heads[owner] = i
        eligible = [(o, i) for o, i in heads.items() if inflight.get(o, 0) < cap]
        if not eligible:
            return None
        return min(eligible, key=lambda kv: (last_map.get(kv[0], -1), kv[1]))

    def _pop_waiting_fair(self) -> CaptionRequest:
        """Next waiting request: one pipeline's burst cannot push another
        pipeline's requests out of the prep pipeline (cross-job fairness
        starts at prep, since only prepped requests can be admitted).
        Single-owner queues reduce to plain FIFO. Lock held by caller."""
        owner, idx = self._fair_head(
            (r.owner for r in self.waiting), self._owner_last_prep, {}, float("inf")
        )
        self._owner_last_prep[owner] = self._prep_seq
        self._prep_seq += 1
        return self.waiting.pop(idx)

    def _safe_prepare(self, req: CaptionRequest) -> "_Prepared | None":
        t0 = time.monotonic()
        try:
            return self._prepare(req)
        except _DEVICE_FAULTS:
            raise
        except Exception:
            logger.exception("prefill prep failed for %s; dropping", req.request_id)
            return None
        finally:
            with self._stats_lock:
                self._prep_time += time.monotonic() - t0

    def _should_linger(self) -> bool:
        """True while admission should hold for the in-flight burst's prep:
        every lane idle, ready requests waiting, more of the burst still
        prepping, and the linger deadline not yet blown. Lock held by
        caller."""
        if not self.async_prep or self.admission_linger_s <= 0:
            return False
        if not self._ready or any(l.slots or l.pending for l in self.lanes):
            self._linger_until = None
            return False
        incoming = len(self.waiting) + (1 if self._prep_inflight is not None else 0)
        free = sum(l.n_slots for l in self.lanes)
        if not incoming or len(self._ready) >= free:
            self._linger_until = None
            return False
        now = time.monotonic()
        if self._linger_until is None:
            self._linger_until = now + self.admission_linger_s
        return now < self._linger_until

    def _owner_cap(self, inflight: dict) -> int:
        """Per-owner in-flight slot cap: an explicit ``owner_inflight_cap``,
        or the fair share of the slot budget across owners that currently
        have work. A single owner gets the whole engine (admission-order
        parity with the single-job engine)."""
        if self.owner_inflight_cap is not None:
            return max(1, self.owner_inflight_cap)
        owners = set(inflight)
        owners.update(r.owner for r in self.waiting)
        owners.update(p.request.owner for p in self._ready)
        if self._prep_inflight is not None:
            owners.add(self._prep_inflight.owner)
        total = sum(l.n_slots for l in self.lanes)
        if len(owners) <= 1:
            return total
        return max(1, -(-total // len(owners)))

    # holds-lock: _lock
    def _next_prepared(self, inflight: dict) -> "_Prepared | None":
        """Next admission candidate: FIFO within an owner, least-recently-
        admitted owner first, owners at their in-flight cap skipped — the
        cross-job interleave. Single-owner queues reduce to plain FIFO. In
        sync mode fall through to inline prep of the waiting queue (same
        owner rotation)."""
        cap = self._owner_cap(inflight)
        if self._ready:
            pick = self._fair_head(
                (p.request.owner for p in self._ready),
                self._owner_last_admit,
                inflight,
                cap,
            )
            if pick is None:
                return None  # every queued owner is at its fair share
            prep = self._ready[pick[1]]
            del self._ready[pick[1]]
            return prep
        if not self.async_prep:
            while self.waiting:
                pick = self._fair_head(
                    (r.owner for r in self.waiting),
                    self._owner_last_prep,
                    inflight,
                    cap,
                )
                if pick is None:
                    return None
                owner, idx = pick
                self._owner_last_prep[owner] = self._prep_seq
                self._prep_seq += 1
                prep = self._safe_prepare(self.waiting.pop(idx))
                if prep is not None:
                    return prep
        return None

    def _route(self, need: int) -> _Lane | None:
        """Pick the lane for a request needing ``need`` positions.

        Utilization-aware admission: every decode step runs a lane's FULL
        slot batch (static shapes), so joining a lane that is already
        decoding adds a token to rows that execute anyway — pure win —
        while opening an idle lane pays its whole batch for one request.
        Among lanes that fit and have a free slot, prefer the smallest
        ACTIVE lane; fall back to the smallest idle one. Exception: a
        request that a SHORTER idle lane could serve must not consume the
        LAST free slot of a longer active lane — long-lane slots are
        scarce (e.g. 2 at 4096 for the 7B default) and burning the last
        one on a short request head-of-line-blocks the next long prompt."""
        first_idle = None
        active = None
        active_free = 0
        for lane in self.lanes:  # sorted by length
            occupied = len(lane.slots) + len(lane.pending) + len(lane.reserved)
            if lane.length < need or occupied >= lane.n_slots:
                continue
            if occupied and active is None:
                active = lane
                active_free = lane.n_slots - occupied
            elif not occupied and first_idle is None:
                first_idle = lane
        if active is not None:
            if (
                first_idle is not None
                and first_idle.length < active.length
                and active_free <= 1
            ):
                return first_idle
            return active
        return first_idle

    def _prompt_len_estimate(self, req: CaptionRequest) -> int:
        """Prompt length WITHOUT running the encoders. Routing now sees the
        prepared request's ACTUAL total (prep precedes admission), so this
        is a planning utility: callers sizing a request against the lanes
        (fit_max_new_tokens, capacity tooling) without paying an encode."""
        n = len(req.prefix_ids) + len(req.prompt_ids)
        if req.frames is not None:
            n += self._vision_token_count(req.frames.shape[0])
        return min(n, self._max_len - req.sampling.max_new_tokens - 1)

    # holds-lock: _lock
    def _admit(self) -> None:
        if self._should_linger():
            return
        # per-owner in-flight counts for the fairness cap (updated as this
        # pass admits, so one pass cannot blow past the cap either)
        inflight: dict[Any, int] = {}
        for l in self.lanes:
            for s in l.slots.values():
                inflight[s.request.owner] = inflight.get(s.request.owner, 0) + 1
            for p in l.pending.values():
                inflight[p.request.owner] = inflight.get(p.request.owner, 0) + 1
        groups: dict[tuple[int, int], list[tuple]] = {}
        while True:
            prep = self._next_prepared(inflight)
            if prep is None:
                break
            req = prep.request
            need = prep.total + req.sampling.max_new_tokens + 1
            lane = self._route(min(need, self._max_len))
            if lane is None:
                # head-of-line waits for a slot to free (FIFO); the prep
                # work is kept, not redone
                self._ready.appendleft(prep)
                break
            lane_budget = lane.length - req.sampling.max_new_tokens - 1
            if prep.total > lane_budget:  # routed lane too short after all
                if req.frames is not None:
                    # never slice a vision block (see _fit_frames_to_budget):
                    # re-route on the ACTUAL token count — _prepare
                    # guarantees the total fits the longest lane, so a lane
                    # exists; None only means it is busy, so requeue at the
                    # head and wait instead of dropping a servable request
                    lane2 = self._route(prep.total + req.sampling.max_new_tokens + 1)
                    if lane2 is None:
                        self._ready.appendleft(prep)
                        break
                    logger.info(
                        "%s: multimodal prompt re-routed %d -> %d lane "
                        "(estimate %d, actual %d tokens)",
                        req.request_id, lane.length, lane2.length,
                        lane_budget, prep.total,
                    )
                    lane = lane2
                    lane_budget = lane.length - req.sampling.max_new_tokens - 1
                else:
                    if prep.base:
                        # tail-keep truncation may cut into the prefix
                        # region: fold the prefix back in first
                        prep = self._materialize_full(prep)
                    prep.embeds = prep.embeds[-lane_budget:]
                    prep.rope = prep.rope[-lane_budget:]
                    if prep.ds is not None:
                        prep.ds = prep.ds[:, -lane_budget:]
                    prep.t_suffix = lane_budget
            # The prefix entry must be resident BEFORE placement decisions:
            # when the pool cannot host it (exhausted with nothing
            # evictable), fold the prefix back into the host embeds and
            # admit uncached — recompute beats waiting on cache memory.
            if prep.base:
                entry, _ = self._ensure_prefix(prep.prefix_key, count=False)
                if entry is None:
                    prep = self._materialize_full(prep)
            # Shared-prefix placement feasibility in THIS lane: a bucketed
            # group prefill writes a [bucket]-length chunk at offset base,
            # which must stay inside the lane. Chunked prefill places
            # exactly (its final chunk shifts back), so prefer it when the
            # suffix is chunkable; otherwise fold the prefix back in.
            group_ok = (
                prep.base + min(next_pow2(prep.t_suffix), lane.length) <= lane.length
            )
            if not group_ok and prep.t_suffix <= self.prefill_chunk:
                prep = self._materialize_full(prep)
                group_ok = True
            # Chunk admission tuned against decode occupancy (the live
            # signal behind decode_slot_utilization): chunking protects
            # in-flight decode from a long prefill stall — with no lane
            # decoding there is nothing to protect, so admit the whole
            # prompt as one bucketed prefill and skip the per-step drip.
            decode_active = any(l.slots for l in self.lanes)
            chunked = prep.t_suffix > self.prefill_chunk and (
                decode_active or not group_ok
            )
            slot_idx = next(
                i
                for i in range(lane.n_slots)
                if i not in lane.slots
                and i not in lane.pending
                and i not in lane.reserved
            )
            try:
                self._claim_kv(lane, slot_idx, prep, req)
            except PoolExhausted:
                if prep.base and not any(l.claims for l in self.lanes):
                    # nothing in flight will free blocks and eviction
                    # spares the entry this claim references — the
                    # request's OWN prefix entry may be hoarding an idle
                    # pool. Fold the prefix back in and retry uncached: a
                    # lone worst-case request always fits an empty pool
                    # (kv_pool_blocks is floored at the lane sum).
                    self._ready.appendleft(self._materialize_full(prep))
                    continue
                # occupancy-based admission: the BLOCK POOL, not slot
                # count, is the limit — wait for in-flight requests to
                # free blocks (prep kept, not redone)
                self._ready.appendleft(prep)
                break
            except _DEVICE_FAULTS:
                raise
            except Exception:
                logger.exception(
                    "KV block claim failed for %s; dropping", req.request_id
                )
                continue
            inflight[req.owner] = inflight.get(req.owner, 0) + 1
            self._owner_last_admit[req.owner] = self._admit_seq
            self._admit_seq += 1
            if chunked:
                # long prompt: prefill in chunks interleaved with decode
                lane.pending[slot_idx] = _PendingPrefill(
                    request=req,
                    embeds=prep.embeds,
                    t_valid=prep.t_suffix,
                    rope_pos=prep.rope,
                    next_rope=prep.next_rope,
                    ds=prep.ds,
                    base=prep.base,
                )
                continue
            bucket = min(next_pow2(prep.t_suffix), lane.length)
            groups.setdefault((self.lanes.index(lane), bucket), []).append(
                (
                    slot_idx,
                    req,
                    prep.embeds,
                    prep.t_suffix,
                    prep.rope,
                    prep.next_rope,
                    prep.ds,
                    prep.base,
                )
            )
            # reserve the slot so this loop's later iterations see it taken
            lane.reserved.add(slot_idx)
        for (lane_i, bucket), items in sorted(groups.items()):
            lane = self.lanes[lane_i]
            for slot_idx, *_ in items:  # release the reservations
                lane.reserved.discard(slot_idx)
            try:
                self._prefill_group(lane, bucket, items)
            except _DEVICE_FAULTS:
                raise
            except Exception:
                if len(items) == 1:
                    logger.exception(
                        "prefill failed for %s; dropping", items[0][1].request_id
                    )
                    self._release_claim(lane, items[0][0])
                    continue
                # isolate the offender: retry each request as its own group
                logger.exception(
                    "batched prefill failed for %d requests; retrying singly",
                    len(items),
                )
                for item in items:
                    try:
                        self._prefill_group(lane, bucket, [item])
                    except _DEVICE_FAULTS:
                        raise
                    except Exception:
                        logger.exception(
                            "prefill failed for %s; dropping", item[1].request_id
                        )
                        self._release_claim(lane, item[0])

    def _prepare(self, req: CaptionRequest) -> _Prepared:
        """Vision encode + token embed for one request.

        When the request's text prefix is shareable (``share_prefix``, long
        enough, cache enabled, no truncation needed), only the SUFFIX
        (vision + prompt text) is embedded — the prefix's K/V come from the
        shared-prefix cache and ``base`` marks where suffix prefill starts.
        Rope positions stay absolute over the full [prefix][vision][prompt]
        layout either way, so cached and uncached prefills write identical
        cache contents (greedy parity). Under m-rope the positions come
        from build_mrope_positions; otherwise they are arange."""
        budget = self._max_len - req.sampling.max_new_tokens - 1
        n_pre = len(req.prefix_ids)
        vis_embeds = None
        ds_vis = None
        grid_merged = None
        eff_fps = None
        if req.frames is not None:
            vf = req.vision_features
            n_text = n_pre + len(req.prompt_ids)
            if vf is not None and n_text + vf.n_tokens <= budget:
                # refinement pass over the SAME frames: reuse the encoded
                # vision features instead of re-running the tower
                vis_embeds, ds_vis = vf.embeds, vf.ds
                grid_merged, eff_fps = vf.grid, vf.eff_fps
                with self._stats_lock:
                    self._vision_reuses += 1
            else:
                frames, eff_fps = self._fit_frames_to_budget(req)
                t0 = time.monotonic()
                vis = self._encode_images(np.asarray(frames)[None])
                if isinstance(vis, tuple):  # qwen3: (embeds, deepstack levels)
                    vis, ds_levels = vis
                    ds_vis = ds_levels[:, 0].float().cpu().numpy()  # [L_ds, T_vis, D]
                vis_embeds = vis[0]
                self._sync()
                with self._stats_lock:
                    self._vision_time += time.monotonic() - t0
                    self._vision_encodes += 1
                if self.cfg.vision_variant in ("qwen2", "qwen3"):
                    grid_merged = self.cfg.qwen_vision.merged_grid(frames.shape[0])
                req.vision_features = _VisionFeatures(
                    embeds=vis_embeds,
                    ds=ds_vis,
                    grid=grid_merged,
                    eff_fps=eff_fps,
                    n_tokens=int(vis_embeds.shape[0]),
                )
        n_vis = 0 if vis_embeds is None else int(vis_embeds.shape[0])
        total = n_pre + n_vis + len(req.prompt_ids)
        use_prefix = (
            self.enable_prefix_cache
            and req.share_prefix
            and n_pre >= self.min_prefix_len
            and n_vis + len(req.prompt_ids) > 0  # suffix must be non-empty
            and total <= budget  # tail-keep truncation cuts into the prefix
        )
        parts = []
        if n_pre and not use_prefix:
            parts.append(self._embed_tokens(req.prefix_ids))
        if vis_embeds is not None:
            parts.append(vis_embeds)
        if req.prompt_ids:
            parts.append(self._embed_tokens(req.prompt_ids))
        embeds = torch.cat(parts, dim=0).float().cpu().numpy()
        if self.cfg.mrope_section is not None:
            if grid_merged is None and n_vis:
                # vit-variant vision tokens: treat as a 1 x 1 x n_vis row
                grid_merged = (1, 1, n_vis)
            # Qwen2.5-VL scales the temporal component to absolute time:
            # t_scale = tokens_per_second * second_per_grid_t, with
            # second_per_grid_t = temporal_patch_size / the frames' sampled
            # rate (HF get_rope_index); Qwen2-VL keeps the unscaled arange
            t_scale = 1.0
            qv = self.cfg.qwen_vision
            if qv is not None and qv.tokens_per_second and eff_fps and grid_merged is not None:
                t_scale = qv.tokens_per_second * qv.temporal_patch_size / eff_fps
            rope_pos, next_rope = build_mrope_positions(n_pre, grid_merged, len(req.prompt_ids), t_scale)
        else:
            rope_pos = np.arange(total, dtype=np.int32)
            next_rope = total
        ds = None
        if ds_vis is not None and self._ds_levels:
            # zeros at text positions, the levels over the vision span;
            # suffix-aligned when the prefix is cached
            off = 0 if use_prefix else n_pre
            ds = np.zeros((self._ds_levels, total - n_pre if use_prefix else total, embeds.shape[-1]), np.float32)
            ds[:, off : off + ds_vis.shape[1]] = ds_vis
        if use_prefix:
            key = tuple(req.prefix_ids)
            _entry, hit = self._ensure_prefix(key)
            if hit:
                with self._stats_lock:
                    self._prefix_tokens_saved += n_pre
            return _Prepared(
                request=req,
                embeds=embeds,
                t_suffix=total - n_pre,
                rope=np.asarray(rope_pos)[n_pre:],
                next_rope=next_rope,
                ds=ds,
                base=n_pre,
                prefix_key=key,
            )
        t_valid = total
        rope_pos = np.asarray(rope_pos)
        if t_valid > budget:
            if req.frames is not None:
                # _fit_frames_to_budget guarantees multimodal prompts fit;
                # slicing here would cut the vision block mid-grid and
                # corrupt the prompt silently
                raise ValueError(
                    f"{req.request_id}: multimodal prompt still over budget "
                    f"after frame reduction ({t_valid} > {budget})"
                )
            # text-only: keep the tail (task instructions usually come
            # last); rope positions stay absolute for the kept tokens
            embeds = embeds[-budget:]
            rope_pos = rope_pos[-budget:]
            if ds is not None:
                ds = ds[:, -budget:]
            t_valid = budget
        return _Prepared(
            request=req,
            embeds=embeds,
            t_suffix=t_valid,
            rope=rope_pos,
            next_rope=next_rope,
            ds=ds,
        )

    def _materialize_full(self, prep: _Prepared) -> _Prepared:
        """Fold the cached prefix back into a prepared request (host-side):
        the fallback when a routed lane cannot place a bucketed suffix at
        offset ``base``, or when tail-keep truncation must see the whole
        layout. Produces the exact uncached prefill inputs."""
        req = prep.request
        n_pre = len(req.prefix_ids)
        pre_emb = self._embed_tokens(req.prefix_ids).float().cpu().numpy()
        t = np.arange(n_pre, dtype=np.int32)
        pre_rope = np.stack([t, t, t], axis=-1) if prep.rope.ndim == 2 else t
        ds = prep.ds
        if ds is not None:
            ds = np.concatenate([np.zeros((ds.shape[0], n_pre, ds.shape[-1]), np.float32), ds], axis=1)
        return _Prepared(
            request=req,
            embeds=np.concatenate([pre_emb, prep.embeds], axis=0),
            t_suffix=n_pre + prep.t_suffix,
            rope=np.concatenate([pre_rope, prep.rope], axis=0),
            next_rope=prep.next_rope,
            ds=ds,
        )

    def _ensure_prefix(
        self, key: tuple, count: bool = True
    ) -> "tuple[_PrefixEntry | None, bool]":
        """(entry, was_hit) for one shared text prefix, prefilling it into
        POOL BLOCKS on first use and LRU-inserting the entry. The scratch
        prefill compute runs without the engine lock (it touches no pool
        state, so the prep thread can build a prefix while the decode loop
        runs); only the final block allocation + pool write takes the
        engine lock — lock order is always engine lock -> prefix lock.
        Returns (None, False) when the pool cannot host the entry even
        after evicting idle prefixes: callers serve the prefix uncached.
        ``count=False`` skips the hit counter (the admission-time re-lookup
        must not double-count the prep-time hit); rebuild misses always
        count — an eviction-rebuild is real recompute."""
        with self._prefix_lock:
            entry = self._prefix_cache.get(key)
            if entry is not None:
                self._prefix_cache.move_to_end(key)
                if count:
                    with self._stats_lock:
                        self._prefix_hits += 1
                return entry, True
        if not self.enable_prefix_cache:
            return None, False
        with self._stats_lock:
            self._prefix_misses += 1
        tp = len(key)
        sp = next_pow2(tp)
        emb = np.zeros((1, sp, self.cfg.dim), np.float32)
        emb[0, :tp] = self._embed_tokens(key).float().cpu().numpy()
        pos = np.zeros((1, sp), np.int32)
        pos[0, :tp] = np.arange(tp, dtype=np.int32)
        if self.cfg.mrope_section is not None:
            # text prefix: all three m-rope components equal
            pos = np.broadcast_to(pos[..., None], (1, sp, 3))
        t0 = time.monotonic()
        k, v = self._prefix_prefill(emb, pos, tp)
        k, v = k[:, :tp], v[:, :tp]
        self._sync()
        with self._stats_lock:
            self._prefill_time += time.monotonic() - t0
            self._prefill_tokens += tp
        bs = self.block_size
        nb = -(-tp // bs)
        with self._lock:
            with self._prefix_lock:
                raced = self._prefix_cache.get(key)
                if raced is not None:  # a concurrent build won: adopt it
                    self._prefix_cache.move_to_end(key)
                    with self._stats_lock:
                        # the outcome is a HIT (the winner's build is
                        # served); reclassify the miss counted up front so
                        # hit-rate stats stay exact under concurrency
                        self._prefix_misses -= 1
                        self._prefix_hits += 1
                    return raced, True
                if not self._allocator.can_alloc(nb):
                    self._evict_prefixes_for(nb)
                if not self._allocator.can_alloc(nb):
                    logger.warning(
                        "prefix cache: pool exhausted; serving %d-token "
                        "prefix uncached", tp,
                    )
                    return None, False
                ids = self._allocator.alloc(nb)
                self._write_prefix_blocks(k, v, ids)
                entry = _PrefixEntry(
                    blocks=ids,
                    n_full=tp // bs,
                    tail_block=ids[-1] if tp % bs else None,
                    length=tp,
                )
                self._prefix_cache[key] = entry
                while len(self._prefix_cache) > self.prefix_cache_size:
                    _k2, evicted = self._prefix_cache.popitem(last=False)
                    # referenced blocks defer their free to the last slot
                    self._allocator.decref(evicted.blocks)
                    with self._stats_lock:
                        self._prefix_evictions += 1
                return entry, False

    # holds-lock: _lock, _prefix_lock
    def _evict_prefixes_for(self, n_blocks: int, exclude: tuple | None = None) -> None:
        """Evict idle LRU prefixes until ``n_blocks`` are allocatable (or
        the cache is empty — referenced blocks free only when their last
        slot releases). ``exclude`` protects the entry a claim in progress
        is about to reference. Engine + prefix locks held by caller."""
        for key in list(self._prefix_cache):
            if self._allocator.can_alloc(n_blocks):
                return
            if key == exclude:
                continue
            evicted = self._prefix_cache.pop(key)
            self._allocator.decref(evicted.blocks)
            with self._stats_lock:
                self._prefix_evictions += 1

    # holds-lock: _lock
    def _claim_kv(
        self, lane: _Lane, slot_idx: int, prep: _Prepared, req: CaptionRequest
    ) -> _BlockClaim:
        """Reserve a request's KV blocks and build its block-table row.

        Shared-prefix full blocks are REFERENCED (incref — zero device
        copies); a
        partially-filled shared tail block is copy-on-write duplicated into
        the request's first private block; the rest of
        ``ceil(need / block_size)`` blocks are fresh private allocations.
        Raises PoolExhausted when the pool cannot supply the private blocks
        (admission backpressure, not an error). Engine lock held by
        caller."""
        bs = self.block_size
        need = min(prep.total + req.sampling.max_new_tokens + 1, lane.length)
        view_blocks = -(-need // bs)
        shared: list[int] = []
        cow_src: int | None = None
        if prep.base:
            with self._prefix_lock:
                entry = self._prefix_cache.get(prep.prefix_key)
            if entry is None:
                # _admit ensured the entry earlier THIS iteration and holds
                # the engine lock inserts/evictions need — it cannot vanish
                raise RuntimeError(f"prefix entry vanished for {req.request_id}")
            shared = list(entry.blocks[: entry.n_full])
            cow_src = entry.tail_block
        private_needed = view_blocks - len(shared)
        if not self._allocator.can_alloc(private_needed):
            if not any(l.claims for l in self.lanes):
                # nothing in flight will ever free blocks — the pool is
                # held by idle prefix entries. Evict them (sparing the one
                # this claim references) instead of deadlocking admission.
                with self._prefix_lock:
                    self._evict_prefixes_for(
                        private_needed,
                        exclude=prep.prefix_key if prep.base else None,
                    )
            if not self._allocator.can_alloc(private_needed):
                raise PoolExhausted(
                    f"{private_needed} KV blocks needed, "
                    f"{self._allocator.free_blocks} free of {self._allocator.capacity}"
                )
        self._allocator.incref(shared)
        private = self._allocator.alloc(private_needed)
        try:
            if cow_src is not None:
                # the suffix extends INTO the partially-filled shared tail
                # block: copy-on-write one block — the only device copy on
                # the whole admission path
                self._copy_blocks([cow_src], [private[0]])
        except BaseException:
            # a failed CoW dispatch must hand the references back, or the
            # shared pool shrinks permanently on every transient error
            self._allocator.decref(shared + private)
            raise
        row = lane.table[slot_idx]
        row[:] = 0
        row[: len(shared)] = shared
        row[len(shared) : view_blocks] = private
        claim = _BlockClaim(shared=shared, private=private)
        lane.claims[slot_idx] = claim
        with self._stats_lock:
            self._requests_admitted += 1
            self._kv_blocks_reserved += view_blocks
            self._kv_private_blocks += len(private)
            self._kv_worstcase_tokens += lane.length
            self._prefix_block_refs += len(shared)
            if cow_src is not None:
                self._kv_cow_copies += 1
            self._kv_blocks_used_peak = max(
                self._kv_blocks_used_peak, self._allocator.used_blocks
            )
            self._owner_requests[req.owner] = (
                self._owner_requests.get(req.owner, 0) + 1
            )
        return claim

    def _release_claim(self, lane: _Lane, slot_idx: int) -> None:
        """Return a slot's block references to the pool. Private blocks
        free immediately; shared prefix blocks free only when the LAST
        reference (including the LRU's own) drops — an evicted-but-still-
        referenced prefix frees here, deferred. Engine lock held by
        caller."""
        claim = lane.claims.pop(slot_idx, None)
        if claim is None:
            return
        self._allocator.decref(claim.all_blocks)
        lane.table[slot_idx, :] = 0
        self._work_cv.notify_all()  # pool-blocked admissions may now fit

    def fit_max_new_tokens(
        self,
        requested: int,
        prompt_ids: list[int],
        prefix_ids: list[int] = (),
        n_frames: int = 0,
    ) -> int:
        """The largest ``max_new_tokens`` (≤ requested, ≥ 1) that leaves
        this prompt inside the longest KV lane — callers with fixed prompts
        clamp generation instead of having the vision block rejected."""
        n = len(prefix_ids) + len(prompt_ids)
        if n_frames:
            n += self._vision_token_count(n_frames)
        return max(1, min(requested, self._max_len - n - 1))

    def _vision_token_count(self, n_frames: int) -> int:
        if self.cfg.vision_variant in ("qwen2", "qwen3"):
            return self.cfg.qwen_vision.tokens_out(n_frames)
        return self.cfg.vision_tokens

    def _fit_frames_to_budget(
        self, req: CaptionRequest
    ) -> tuple[np.ndarray | None, float | None]:
        """An over-budget multimodal prompt re-samples FEWER frames instead
        of silently slicing the vision block (tail-keep on a frames-heavy
        request would drop leading vision tokens mid-grid, producing a
        grammatically-valid but semantically-corrupt prompt). Raises when even one frame cannot fit —
        the caller's text leaves no room for vision.

        Returns (frames, effective_fps): re-sampling spreads fewer frames
        over the SAME source span, so the temporal m-rope scale must use
        the reduced rate, not the request's original frame_fps."""
        frames = req.frames
        if frames is None:
            return None, None
        budget = self._max_len - req.sampling.max_new_tokens - 1
        n_text = len(req.prefix_ids) + len(req.prompt_ids)
        n = frames.shape[0]
        if n_text + self._vision_token_count(n) <= budget:
            return frames, req.frame_fps
        for n2 in range(n - 1, 0, -1):
            if n_text + self._vision_token_count(n2) <= budget:
                idx = np.linspace(0, n - 1, n2).round().astype(int)
                logger.warning(
                    "%s: prompt over budget; re-sampled %d -> %d frames",
                    req.request_id,
                    n,
                    n2,
                )
                eff = req.frame_fps * (n2 / n) if req.frame_fps else None
                return frames[idx], eff
        raise ValueError(
            f"{req.request_id}: text prompt ({n_text} tokens) leaves no room "
            f"for any vision tokens within budget {budget}"
        )

    # holds-lock: _lock
    def _prefill_group(self, lane: _Lane, bucket: int, items: list) -> None:
        """One batched prefill for all requests sharing a length bucket.

        The row count is padded to a power of two by duplicating row 0
        (same table + same content → the duplicate scatter writes identical
        values), so the reference engine's shapes, and its tokens, carry
        over. Bucket padding may write past a row's reserved
        blocks ([base, base + bucket) can overshoot need): those positions
        map to garbage-block table entries, whose contents are never read
        unmasked."""
        n = len(items)
        n_pad = next_pow2(n)  # bounded by next_pow2(lane.n_slots)
        dim = items[0][2].shape[-1]
        embeds = np.zeros((n_pad, bucket, dim), np.float32)
        slots_arr = np.zeros(n_pad, np.int32)
        t_valids = np.ones(n_pad, np.int32)
        bases = np.zeros(n_pad, np.int32)
        mrope = self.cfg.mrope_section is not None
        rope_shape = (n_pad, bucket, 3) if mrope else (n_pad, bucket)
        rope_buf = np.zeros(rope_shape, np.int32)
        # deepstack rows of text-only requests stay zero
        ds_buf = np.zeros((self._ds_levels, n_pad, bucket, dim), np.float32) if self._ds_levels else None
        for j, (slot_idx, _req, emb, t_valid, rope_pos, _next, ds, base) in enumerate(items):
            embeds[j, :t_valid] = np.asarray(emb, np.float32)[:t_valid]
            slots_arr[j] = slot_idx
            t_valids[j] = t_valid
            bases[j] = base  # shared-prefix rows start past their cached K/V
            rope_buf[j, :t_valid] = rope_pos[:t_valid]
            if ds_buf is not None and ds is not None:
                ds_buf[:, j, :t_valid] = ds[:, :t_valid]
        for j in range(n, n_pad):  # duplicate row 0 into padding
            embeds[j] = embeds[0]
            slots_arr[j] = slots_arr[0]
            t_valids[j] = t_valids[0]
            bases[j] = bases[0]
            rope_buf[j] = rope_buf[0]
            if ds_buf is not None:
                ds_buf[:, j] = ds_buf[:, 0]
        t0 = time.monotonic()
        tables = lane.table[slots_arr]  # [n_pad, nbl]; padding rows = row 0
        logits = self._prefill_batch(tables, embeds, bases, t_valids, rope_buf, ds_buf)
        logits_np = logits.float().cpu().numpy()  # one host sync for the whole group
        with self._stats_lock:
            self._prefill_time += time.monotonic() - t0
            self._prefill_tokens += int(sum(it[3] for it in items))
        for j, (slot_idx, req, _emb, t_valid, _rope, next_rope, _ds, base) in enumerate(items):
            self._start_slot(lane, slot_idx, req, base + t_valid, next_rope, logits_np[j])

    def _start_slot(
        self,
        lane: _Lane,
        slot_idx: int,
        req: CaptionRequest,
        t_valid: int,
        next_rope: int,
        logits_row: np.ndarray,
    ) -> None:
        """Sample the first token from the last-prompt-position logits and
        enter the slot into the continuous decode batch."""
        # seed=None is the unseeded sentinel; any int (incl. 0) pins
        rng = (
            np.random.default_rng(req.sampling.seed)
            if req.sampling.seed is not None
            else None
        )
        counts: dict[int, int] | None = None
        s = req.sampling
        if (
            s.repetition_penalty != 1.0
            or s.presence_penalty != 0.0
            or s.frequency_penalty != 0.0
        ):
            # penalty history covers prompt tokens too (vLLM
            # semantics); maintained incrementally from here on
            counts = {}
            for t in [*req.prefix_ids, *req.prompt_ids]:
                counts[t] = counts.get(t, 0) + 1
        first = sample_token(
            logits_row,
            req.sampling,
            generated=counts,
            num_generated=0,
            eos_id=self.tokenizer.eos_id,
            rng=rng if rng is not None else self._host_rng,
        )
        slot = _Slot(
            request=req,
            position=t_valid,
            rope_position=next_rope,
            generated=[first],
            rng=rng,
            penalty_counts=counts,
        )
        if counts is not None:
            counts[first] = counts.get(first, 0) + 1
        if req.sampling.stop:
            slot.raw += self.tokenizer.decode_bytes([first])
        lane.slots[slot_idx] = slot
        self._maybe_finish(lane, slot_idx, slot)

    # holds-lock: _lock
    def _prefill_chunk_step(self, lane: _Lane) -> None:
        """Advance every pending chunked prefill by one chunk (one batched
        program call); rows finishing their prompt enter the decode batch."""
        C = self.prefill_chunk
        items = list(lane.pending.items())
        if not items:
            return
        n = len(items)
        n_pad = next_pow2(n)  # bounded by next_pow2(lane.n_slots)
        dim = items[0][1].embeds.shape[-1]
        mrope = self.cfg.mrope_section is not None
        embeds = np.zeros((n_pad, C, dim), np.float32)
        slots_arr = np.zeros(n_pad, np.int32)
        write_idx = np.zeros(n_pad, np.int32)
        chunk_valid = np.ones(n_pad, np.int32)
        rope_buf = np.zeros((n_pad, C, 3) if mrope else (n_pad, C), np.int32)
        ds_buf = np.zeros((self._ds_levels, n_pad, C, dim), np.float32) if self._ds_levels else None
        new_tokens = 0
        for j, (slot_idx, p) in enumerate(items):
            take = min(C, p.t_valid - p.progress)
            start = p.progress
            if take < C:
                # final partial chunk: shift back so the C-length buffer
                # ends exactly at the prompt end. The overlapped rows
                # rewrite identical K/V (same embeds, same rope, correct
                # causal mask), and the chunk's write stays in bounds
                # for shared-prefix bases > 0 and for lane lengths that are
                # not a multiple of the chunk size.
                start = p.t_valid - C
            new_tokens += take
            embeds[j] = p.embeds[start : start + C]
            slots_arr[j] = slot_idx
            write_idx[j] = p.base + start
            chunk_valid[j] = C if start < p.progress else take
            rope_buf[j] = p.rope_pos[start : start + C]
            if ds_buf is not None and p.ds is not None:
                ds_buf[:, j] = p.ds[:, start : start + C]
        for j in range(n, n_pad):  # duplicate row 0 (identical writes: safe)
            embeds[j] = embeds[0]
            slots_arr[j] = slots_arr[0]
            write_idx[j] = write_idx[0]
            chunk_valid[j] = chunk_valid[0]
            rope_buf[j] = rope_buf[0]
            if ds_buf is not None:
                ds_buf[:, j] = ds_buf[:, 0]
        t0 = time.monotonic()
        tables = lane.table[slots_arr]  # [n_pad, nbl]; padding rows = row 0
        logits = self._prefill_batch(tables, embeds, write_idx, chunk_valid, rope_buf, ds_buf)
        finished = []
        for j, (slot_idx, p) in enumerate(items):
            p.progress += min(C, p.t_valid - p.progress)
            if p.progress >= p.t_valid:
                finished.append((j, slot_idx, p))
        if finished:
            logits_np = logits.float().cpu().numpy()
            for j, slot_idx, p in finished:
                del lane.pending[slot_idx]
                self._start_slot(
                    lane, slot_idx, p.request, p.base + p.t_valid, p.next_rope,
                    logits_np[j],
                )
        with self._stats_lock:
            self._prefill_time += time.monotonic() - t0
            self._prefill_tokens += new_tokens

    # holds-lock: _lock
    def _decode_once(self, lane: _Lane) -> None:
        tokens = np.full(lane.n_slots, self.tokenizer.pad_id, np.int32)
        positions = np.zeros(lane.n_slots, np.int32)
        rope_positions = np.zeros(lane.n_slots, np.int32)
        # The decode program scatters K/V for EVERY row (static shapes, no
        # write mask), so idle rows' write positions must be harmless.
        # Fully-free rows carry an all-garbage block table — their write
        # lands in the reserved garbage block — but a row mid-chunked-
        # prefill holds real prompt K/V: point its write at base +
        # progress, a cell the NEXT chunk overwrites anyway (the shifted
        # final chunk covers [t_valid - C, t_valid), which contains it), so
        # the pad-token garbage can never survive into attention reads.
        for i, p in lane.pending.items():
            positions[i] = p.base + p.progress
        for i, slot in lane.slots.items():
            tokens[i] = slot.generated[-1]
            positions[i] = slot.position
            rope_positions[i] = slot.rope_position
        t0 = time.monotonic()
        # greedy ids come back in ONE host sync for the whole batch
        greedy_np, logits = self._decode(lane.table, tokens, positions, rope_positions)
        dt = time.monotonic() - t0
        with self._stats_lock:
            self._decode_time += dt
            self._decode_tokens += len(lane.slots)
            self._decode_rows += lane.n_slots
            if self._use_paged:
                self._paged_kernel_steps += 1
            for slot in lane.slots.values():
                owner = slot.request.owner
                self._owner_decode_tokens[owner] = (
                    self._owner_decode_tokens.get(owner, 0) + 1
                )
        # the device argmax suffices only for pure-greedy rows with no
        # penalties and min_tokens already satisfied
        needs_logits = any(
            s.request.sampling.needs_logits(len(s.generated))
            for s in lane.slots.values()
        )
        logits_np = logits.float().cpu().numpy() if needs_logits else None
        for i in list(lane.slots):
            slot = lane.slots[i]
            if slot.request.sampling.needs_logits(len(slot.generated)):
                nxt = sample_token(
                    logits_np[i],
                    slot.request.sampling,
                    # incrementally maintained prompt+output counts; the
                    # decode loop must not re-unique the history per token
                    generated=slot.penalty_counts,
                    num_generated=len(slot.generated),
                    eos_id=self.tokenizer.eos_id,
                    rng=slot.rng if slot.rng is not None else self._host_rng,
                )
            else:
                nxt = int(greedy_np[i])
            slot.generated.append(nxt)
            if slot.penalty_counts is not None:
                slot.penalty_counts[nxt] = slot.penalty_counts.get(nxt, 0) + 1
            if slot.request.sampling.stop:
                slot.raw += self.tokenizer.decode_bytes([nxt])
            slot.position += 1
            slot.rope_position += 1
            self._maybe_finish(lane, i, slot)

    def _maybe_finish(self, lane: _Lane, slot_idx: int, slot: _Slot) -> None:
        req = slot.request
        done = (
            slot.generated[-1] == self.tokenizer.eos_id
            or len(slot.generated) >= req.sampling.max_new_tokens
            or slot.position + 1 >= lane.length
        )
        stop_text: str | None = None
        if not done and req.sampling.stop:
            # stop strings match on decoded text (vLLM `stop`); the match
            # and everything after it is dropped. The hot path scans only a
            # bounded tail of the incrementally maintained byte buffer
            # (slot.raw — exact regardless of zero-byte special tokens);
            # the full decode runs once, on a hit.
            longest = max(len(s) for s in req.sampling.stop)
            tail = bytes(slot.raw[-(4 * longest + 8) :]).decode("utf-8", errors="replace")
            if any(s in tail for s in req.sampling.stop):
                stop_text = _truncate_at_stop(
                    bytes(slot.raw).decode("utf-8", errors="replace"), req.sampling.stop
                )
                done = stop_text is not None
        if not done:
            return
        del lane.slots[slot_idx]
        self._release_claim(lane, slot_idx)
        out_ids = [t for t in slot.generated if t != self.tokenizer.eos_id]
        text = stop_text if stop_text is not None else self.tokenizer.decode(out_ids)
        if stop_text is None and req.sampling.stop:
            # a stop string may land in the same step that hit eos/max
            truncated = _truncate_at_stop(text, req.sampling.stop)
            if truncated is not None:
                text = truncated
        result = CaptionResult(
            request_id=req.request_id,
            text=text,
            num_prompt_tokens=len(req.prefix_ids) + len(req.prompt_ids),
            num_output_tokens=len(slot.generated),
            metadata=req.metadata,
            owner=req.owner,
        )
        if req.on_complete is not None:
            follow_up = req.on_complete(text)
            if follow_up is not None:
                if follow_up.owner is None:
                    follow_up.owner = req.owner
                if (
                    follow_up.frames is not None
                    and follow_up.frames is req.frames
                    and follow_up.vision_features is None
                ):
                    # refinement over the SAME frames array: hand the
                    # already-encoded vision features to the follow-up so
                    # the tower doesn't run twice per window
                    follow_up.vision_features = req.vision_features
                self.waiting.append(follow_up)
                self._work_cv.notify_all()  # wake the prep thread
                return  # result superseded by the refinement pass
        self.completed.append(result)
