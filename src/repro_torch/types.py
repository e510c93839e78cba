"""Configuration dataclasses of the port: own copies of the reference's
`ModelConfig` (with `reduced()`), `ShapeConfig`, `CollabConfig`,
`FleetConfig` and `TrainConfig` (repro/types.py), field for field, so a
config built for one package reads the same in the other."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads

    # --- attention ---
    attn_kind: str = "gqa"           # gqa | mla
    rope_kind: str = "rope"          # rope | rope2d | mrope | none
    rope_theta: float = 10000.0
    sliding_window: int = 0          # 0 = full attention (training-time SWA)

    # --- MLA (deepseek-v2 / minicpm3) ---
    q_lora_rank: int = 0             # 0 -> full-rank queries
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 0              # 0 -> head_dim

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.5
    router_aux_weight: float = 0.01

    # --- SSM / hybrid / xlstm ---
    block_pattern: Tuple[str, ...] = ()   # per-layer kinds; () -> all "attn"
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_heads: int = 0               # mamba2 heads; 0 -> d_inner // 64
    shared_attn_period: int = 0      # zamba2: shared attn block every k layers
    ssm_chunk: int = 256             # SSD chunk length

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    encoder_seq: int = 1500          # frames after the conv stub

    # --- misc ---
    norm_eps: float = 1e-5
    norm_kind: str = "rmsnorm"       # rmsnorm | layernorm
    mlp_kind: str = "swiglu"         # swiglu | gelu
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    input_kind: str = "tokens"       # tokens | embeddings (vlm/audio stubs)

    # --- CoRS (the paper) ---
    d_feature: int = 0               # d' (0 -> d_model): last-hidden width

    # --- sharding hints ---
    fsdp: bool = False               # shard params over data axis too
    long_context_mode: str = "swa"   # swa | native | skip  (for long_500k)
    swa_window: int = 8192           # window used by the long_500k swa variant

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.v_head_dim == 0:
            object.__setattr__(self, "v_head_dim", self.head_dim)
        if self.d_feature == 0:
            object.__setattr__(self, "d_feature", self.d_model)
        if not self.block_pattern:
            object.__setattr__(
                self, "block_pattern", tuple(["attn"] * self.num_layers))
        assert len(self.block_pattern) == self.num_layers, (
            self.name, len(self.block_pattern), self.num_layers)

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def mamba_heads(self) -> int:
        return self.ssm_heads or max(1, self.d_inner // 64)

    @property
    def mamba_head_dim(self) -> int:
        return self.d_inner // self.mamba_heads

    @property
    def is_mla(self) -> bool:
        return self.attn_kind == "mla"

    @property
    def qk_head_dim(self) -> int:
        if self.is_mla:
            return self.qk_nope_dim + self.qk_rope_dim
        return self.head_dim

    def reduced(self, *, num_layers: int = 2, d_model: int = 256,
                vocab_size: int = 512, num_experts: int = 0,
                seq_cap: int = 0) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        heads = min(self.num_heads, 4)
        kv = min(self.num_kv_heads, heads)
        while heads % kv:
            kv -= 1
        hd = max(16, d_model // heads)
        d_model = hd * heads
        n_exp = num_experts or (min(self.num_experts, 4) if self.num_experts else 0)
        pattern = _reduced_pattern(self.block_pattern, num_layers)
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=hd,
            v_head_dim=0,
            d_ff=max(4 * hd, 64) if self.d_ff else 0,
            vocab_size=vocab_size,
            num_experts=n_exp,
            experts_per_token=min(self.experts_per_token, max(n_exp // 2, 1)) if n_exp else 0,
            moe_d_ff=64 if n_exp else 0,
            num_shared_experts=min(self.num_shared_experts, 1),
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.kv_lora_rank else 0,
            qk_rope_dim=16 if self.is_mla else self.qk_rope_dim,
            qk_nope_dim=hd if self.is_mla else self.qk_nope_dim,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=4 if self.ssm_state else 0,
            ssm_chunk=16,
            shared_attn_period=2 if self.shared_attn_period else 0,
            num_encoder_layers=2 if self.is_encoder_decoder else 0,
            encoder_seq=8 if self.is_encoder_decoder else self.encoder_seq,
            block_pattern=pattern,
            d_feature=0,
            dtype="float32",
            fsdp=False,
        )


def _reduced_pattern(pattern: Tuple[str, ...], n: int) -> Tuple[str, ...]:
    kinds = []
    seen = []
    for k in pattern:
        if k not in seen:
            seen.append(k)
    # keep one layer of each distinct kind, cycling, up to n layers
    for i in range(n):
        kinds.append(seen[i % len(seen)])
    return tuple(kinds)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    mode: str                        # train | prefill | decode




@dataclass(frozen=True)
class CollabConfig:
    """Hyper-parameters of the paper's technique (CoRS)."""
    lambda_kd: float = 10.0          # paper Fig.3 chosen value
    lambda_disc: float = 1.0
    n_avg: int = 10                  # samples per observation average
    m_up: int = 1                    # observations uploaded per class/round
    m_down: int = 1                  # observations downloaded per class/round
    num_classes: int = 10
    d_feature: int = 84
    num_negatives: int = 0           # 0 -> K = C-1 (paper); >0 -> sampled (LM)
    proto_momentum: float = 0.0      # 0 = per-round recompute (paper); >0 EMA
    mode: str = "cors"               # cors | il | fedavg | fd | cl


@dataclass(frozen=True)
class FleetConfig:
    """Who the fleet is and how it behaves (relay policy, participation,
    clocks, mesh, arrivals). The port's trainers run any relay policy,
    the sharded one included (`relay.get_policy`), any participation
    schedule (`relay.get_schedule`), any upload and download clock
    (`sim.get_clock`, `sim.get_download_clock`) and streaming arrivals
    (`sim.get_arrivals`; not with a schedule, an upload clock with
    D_max > 0, a download clock, a mode without a relay or a mixed fleet,
    as in the reference).

    mesh: None, or a `torch.distributed` DeviceMesh with a "clients" axis
    (`sharding.client_mesh(W)`, built in every rank of an initialized
    process group): the vectorized engine then holds N / W clients a rank
    and exchanges the round's uploads once (`relay/placement.py`); W must
    divide N. The sequential engine refuses a mesh."""
    policy: Any = None
    participation: Any = None
    clock: Any = None
    download_clock: Any = None
    mesh: Any = None
    arrivals: Any = None


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3      # paper default
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0
    batch_size: int = 32
    local_epochs: int = 1            # E in Algorithm 2
    rounds: int = 20
    seed: int = 0
    optimizer: str = "adam"
    warmup_steps: int = 0
    schedule: str = "constant"       # constant | cosine
