"""Plain reference of a CoRS fleet of LeNet5 clients (the paper's
Algorithms 1 and 2), in float32 PyTorch.

It imports nothing of the program. From the configuration, the traffic and
the seed it works out again what the program's fleet starts from and
draws: the weights and data (`benchlib/images.py`, the same
generator the benchmark hands the program), the relay's seeded
observations and prototypes, and each round's teacher noise and
observation priorities, by the rules the configuration states for them.
Then it runs the rounds, every client at once on a leading client axis:
each client samples a teacher from the ring (another client's
observation, uniformly, by Gumbel noise), trains its local epoch on
L_CE + lambda_KD L_KD + lambda_disc L_disc with Adam, uploads its
per-class sums and one observation per class (m_up = 1), the server
appends the observations to the ring and recomputes the prototypes, and
every client is evaluated on the shared test set.

`precision` rounds every product's operands ("tf32": the control a
float32 configuration is held against; `ref/precision.py`).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ref.precision import operand

EMPTY_OWNER, SEED_OWNER = -2, -1
EPS = 1e-7
LEAVES = ("conv1", "b1", "conv2", "b2", "fc1", "fb1", "fc2", "fb2",
          "head_w", "head_b")


# ---------------------------------------------------------------------------
# the draws, by the rule the configuration states
# ---------------------------------------------------------------------------
def _gen(seed: int, r: int, i: int, kind: int) -> torch.Generator:
    seq = np.random.SeedSequence([seed, r, i, kind])
    return torch.Generator().manual_seed(int(seq.generate_state(1)[0]))


def teacher_draw(seed, r, i, m_down, cap):
    g = _gen(seed, r, i, 0)
    u = torch.rand(m_down, cap, generator=g)
    noise = -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))
    pick = int(torch.randint(0, m_down, (), generator=g))
    return noise, pick


def priorities(seed, r, i, m_up, n):
    return torch.rand(m_up, n, generator=_gen(seed, r, i, 1))


def init_relay(seed: int, C: int, d: int, cap: int, m_down: int, dev):
    n_seed = min(cap, max(1, m_down))
    rng = np.random.default_rng(seed)
    protos = rng.normal(size=(C, d)).astype(np.float32) * 0.01
    obs = np.zeros((cap, C, d), np.float32)
    obs[:n_seed] = rng.normal(size=(n_seed, C, d)).astype(np.float32) * 0.01
    valid = np.zeros((cap, C), bool)
    valid[:n_seed] = True
    owner = np.full((cap,), EMPTY_OWNER, np.int64)
    owner[:n_seed] = SEED_OWNER
    t = lambda a: torch.from_numpy(a).to(dev)
    return {"obs": t(obs), "valid": t(valid), "owner": t(owner),
            "ptr": n_seed % cap, "global_protos": t(protos),
            "valid_g": torch.ones(C, dtype=torch.bool, device=dev),
            "stamp": torch.zeros(cap, dtype=torch.int64, device=dev),
            "clock": 0}


# ---------------------------------------------------------------------------
# the model and the losses, every client at once on a leading client axis
# (grouped convolutions and batched products; clients share no parameter,
# so the gradient of the sum of their losses is each one's own)
# ---------------------------------------------------------------------------
def lenet(p, x, prec):
    """p: leaves (N, ...); x (N, B, 28, 28, 1) NHWC -> features (N, B, d'),
    logits (N, B, C)."""
    N, B = x.shape[:2]
    h = x.permute(1, 0, 4, 2, 3).reshape(B, N * x.shape[-1], *x.shape[2:4])

    def conv(h, w, b):
        co = w.shape[1]
        out = F.conv2d(operand(h, prec), operand(w.reshape(N * co,
                                                          *w.shape[2:]), prec),
                       b.reshape(N * co), groups=N)
        return F.max_pool2d(F.relu(out), 2)

    h = conv(h, p["conv1"], p["b1"])
    h = conv(h, p["conv2"], p["b2"])
    c2, s2 = p["conv2"].shape[1], h.shape[-1]
    # NHWC flatten order, each client's block
    h = h.reshape(B, N, c2, s2, s2).permute(1, 0, 3, 4, 2).reshape(N, B, -1)
    h = F.relu(torch.bmm(operand(h, prec), operand(p["fc1"], prec))
               + p["fb1"][:, None])
    s = torch.tanh(torch.bmm(operand(h, prec), operand(p["fc2"], prec))
                   + p["fb2"][:, None])
    z = torch.bmm(operand(s, prec), operand(p["head_w"], prec)) \
        + p["head_b"][:, None]
    return s, z


def fleet_loss(p, x, y, teacher, cfg, mode, prec):
    """-> (N,) each client's loss on its batch x (N, B, ...), y (N, B)."""
    s, z = lenet(p, x, prec)
    yl = y.long()
    ce = -torch.log_softmax(z, -1).gather(-1, yl[..., None])[..., 0].mean(-1)
    if mode != "cors":
        return ce
    C = z.shape[-1]
    # L_KD: squared distance to the label's global prototype, mean per dim
    t = teacher["global_protos"][yl]                           # (N, B, d')
    w = teacher["valid_g"].float()[yl]
    kd = (((s - t) ** 2).mean(-1) * w).sum(-1) / w.sum(-1).clamp(min=1.0)
    # L_disc: each client's own head as the discriminator, one downloaded
    # observation per class as the teachers, K = C - 1 negatives
    obs = teacher["obs"]                                       # (N, C, d')
    q = torch.softmax(torch.bmm(operand(obs, prec),
                                operand(p["head_w"], prec))
                      + p["head_b"][:, None], -1)              # (N, C, C)
    pr = torch.softmax(z, -1)
    h = torch.bmm(operand(pr, prec), operand(q, prec).transpose(1, 2)
                  ).clamp(EPS, 1 - EPS)                        # (N, B, C)
    pos = F.one_hot(yl, C).float()
    v = teacher["valid_o"].float()                             # (N, C)
    per = -(pos * torch.log(h) + (1 - pos) * torch.log1p(-h)) * v[:, None]
    sv = v.gather(1, yl)
    disc = (per.sum(-1) * sv).sum(-1) / sv.sum(-1).clamp(min=1.0)
    return ce + cfg["lambda_kd"] * kd + cfg["lambda_disc"] * disc


def adam(p, g, st, cfg):
    st["t"] += 1
    t = float(st["t"])
    b1, b2, eps, lr = cfg["beta1"], cfg["beta2"], cfg["eps"], cfg["lr"]
    bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
    bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
    out = {}
    for k in p:
        st["m"][k] = b1 * st["m"][k] + (1 - b1) * g[k]
        st["v"][k] = b2 * st["v"][k] + (1 - b2) * g[k] ** 2
        u = (st["m"][k] / bc1) / (torch.sqrt(st["v"][k] / bc2) + eps)
        out[k] = p[k] - lr * u
    return out


def observations(prio, feats, y, C: int, n_avg: int):
    """Each client's average of its n_avg highest-priority samples of each
    class (prio (N, n), one draw a client) -> (N, C, d'), and which
    classes each client holds (N, C)."""
    N, n, d = feats.shape
    order = torch.argsort(-prio, dim=-1, stable=True)          # (N, n)
    yo = y.long().gather(1, order)
    fo = feats.gather(1, order[..., None].expand(N, n, d))
    onehot = F.one_hot(yo, C)                                  # (N, n, C)
    rank = (onehot.cumsum(1) * onehot).sum(-1)                 # 1-based
    keep = (rank <= n_avg).float()
    sums = torch.zeros(N, C, d, device=feats.device).scatter_add_(
        1, yo[..., None].expand(N, n, d), fo * keep[..., None])
    cnt = torch.zeros(N, C, device=feats.device).scatter_add_(1, yo, keep)
    present = onehot.sum(1) > 0
    return sums / cnt.clamp(min=1.0)[..., None], present


# ---------------------------------------------------------------------------
# the rounds
# ---------------------------------------------------------------------------
def run_rounds(cfg: Dict, traffic: Dict, seed: int, params0: Dict,
               data: Dict, rounds: int, prec: str = "float32") -> Dict:
    """params0: leaf -> (N, ...) float32; data: x (N, n, 28, 28, 1), y (N,
    n), test_x, test_y. -> what the check compares: each round's mean last
    -batch loss and mean accuracy, the per-client accuracies, the first
    moment's per-leaf norms after round 1, the per-leaf norms of the
    change after `rounds`, the ring's integers and the prototypes."""
    mode = traffic["mode"]
    N = params0["conv1"].shape[0]
    C, d = cfg["num_classes"], cfg["d_feature"]
    bs, m_up, m_down = cfg["batch_size"], cfg["m_up"], cfg["m_down"]
    dev = params0["conv1"].device
    cap = 32 * max(1, N) * max(1, m_up)
    relay = init_relay(seed, C, d, cap, m_down, dev)
    x, y = data["x"], data["y"]
    n = x.shape[1]
    nb = n // bs
    p = {k: params0[k].clone() for k in LEAVES}
    opt = {"t": 0, "m": {k: torch.zeros_like(v) for k, v in p.items()},
           "v": {k: torch.zeros_like(v) for k, v in p.items()}}
    ids = torch.arange(N, device=dev)
    out = {"loss": [], "acc": [], "accs": []}
    for r in range(rounds):
        teacher = None
        if mode == "cors":
            draws = [teacher_draw(seed, r, i, m_down, cap) for i in range(N)]
            noise = torch.stack([dr[0] for dr in draws]).to(dev)  # (N, M, cap)
            pick = torch.tensor([dr[1] for dr in draws], device=dev)
            usable = relay["owner"] != EMPTY_OWNER
            others = usable[None] & (relay["owner"][None] != ids[:, None])
            pool = torch.where(others.any(-1, keepdim=True), others,
                               usable[None])                     # (N, cap)
            idx = noise.masked_fill(~pool[:, None], float("-inf")).argmax(-1)
            teacher = {"global_protos": relay["global_protos"],
                       "valid_g": relay["valid_g"],
                       "obs": relay["obs"][idx[ids, pick]],       # (N, C, d')
                       "valid_o": relay["valid"][idx].all(1)}
        for j in range(nb):
            xb, yb = x[:, j * bs:(j + 1) * bs], y[:, j * bs:(j + 1) * bs]
            q = {k: v.detach().requires_grad_(True) for k, v in p.items()}
            loss = fleet_loss(q, xb, yb, teacher, cfg, mode, prec)
            g = dict(zip(LEAVES, torch.autograd.grad(
                loss.sum(), [q[k] for k in LEAVES])))
            p = adam({k: v.detach() for k, v in q.items()}, g, opt, cfg)
        if mode == "cors":
            with torch.no_grad():
                s, _ = lenet(p, x, prec)
                pr = torch.stack([priorities(seed, r, i, m_up, n)[0]
                                  for i in range(N)]).to(dev)
                ob, present = observations(pr, s, y, C, cfg["n_avg"])
                yy = y.long()
                psum = torch.zeros(N, C, d, device=dev).scatter_add_(
                    1, yy[..., None].expand(N, n, d), s)
                pcnt = F.one_hot(yy, C).float().sum(1)
            relay = commit(relay, ob, present, psum, pcnt, cap)
        if r == 0:
            out["moment1_norms"] = {
                k: float(torch.linalg.vector_norm(opt["m"][k]))
                for k in LEAVES}
        accs = evaluate(p, data["test_x"], data["test_y"], prec)
        out["loss"].append(float(loss.detach().mean()))
        out["acc"].append(float(np.mean(accs)))
        out["accs"].append(accs)
    out["change_norms"] = {k: float(torch.linalg.vector_norm(p[k] - params0[k]))
                           for k in LEAVES}
    out["ring"] = {"owner": relay["owner"].cpu().numpy(),
                   "valid": relay["valid"].cpu().numpy(),
                   "stamp": relay["stamp"].cpu().numpy(),
                   "ptr": relay["ptr"], "clock": relay["clock"]}
    out["global_protos"] = relay["global_protos"].cpu()
    return out


def commit(relay, ob, present, psum, pcnt, cap):
    """The server's round (m_up = 1): every client's observation row
    appended to the ring in client order, stamped with the clock, then the
    prototypes recomputed from this round's sums and the clock ticked."""
    relay = dict(relay)
    N = ob.shape[0]
    rows = (relay["ptr"] + torch.arange(N, device=ob.device)) % cap
    for k, v in (("obs", ob), ("valid", present),
                 ("owner", torch.arange(N, device=ob.device)),
                 ("stamp", torch.full((N,), relay["clock"],
                                      device=ob.device))):
        relay[k] = relay[k].clone()
        relay[k][rows] = v.to(relay[k].dtype)
    relay["ptr"] = (relay["ptr"] + N) % cap
    tot, cnt = psum.sum(0), pcnt.sum(0)
    relay["global_protos"] = tot / cnt.clamp(min=1.0)[:, None]
    relay["valid_g"] = cnt > 0
    relay["clock"] += 1
    return relay


@torch.no_grad()
def evaluate(p: Dict, tx, ty, prec) -> List[float]:
    N = p["conv1"].shape[0]
    hits = torch.zeros(N, device=tx.device)
    for a in range(0, tx.shape[0], 250):
        xb = tx[a:a + 250]
        _, z = lenet(p, xb[None].expand(N, *xb.shape), prec)
        hits += (z.argmax(-1) == ty[a:a + 250].long()[None]).sum(-1)
    return (hits / tx.shape[0]).tolist()
