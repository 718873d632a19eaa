"""Neural / RL research-tree components (reference P5 + P7, SURVEY §2.4).

Reimplements the capabilities of the reference's exploratory learning
stack on JAX (flax/optax instead of torch/stable-baselines3):

  * canonical k-mer profiles (`seed_selection/utils.py:86-117`,
    `dataset.py:23-33`): map every k-mer to min(hash, revcomp-hash) and
    build binary presence vectors — vectorized numpy table, no JSON dict.
  * ``MLPBucketClassifier`` (`seed_selection/dataset.py:111-129`): the
    1-hidden-layer (d_model=2048 default) read→bucket classifier that
    reached 98.5% train accuracy in the reference's log; flax + optax,
    jitted train step, profiles built on device.
  * ``ReadDataset`` (`RNN_categorization.py`, a torch Dataset stub in the
    reference): batched (profile, bucket) sampler backed by the
    production simulator's error model.
  * ``RepetitiveRegionFilter`` (`seed_selection/filter.py:8-31`): bucket
    pairwise Jaccard-index matrix over k-mer profiles — here ONE matmul
    (MXU) instead of the reference's O(B^2) python loop.
  * ``ReferenceGenomeEnv`` + ``DQNAgent`` (`reinforcement_learning.py`):
    the bucket-guessing environment with the same step/reset semantics
    (uniform read position, reward = correct bucket, single-step
    episodes) and a compact replay-buffer DQN in flax.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from bucketmap_tpu.config import MapperConfig
from bucketmap_tpu.index.builder import iterate_buckets
from bucketmap_tpu.io.fasta import FastaRecord
from bucketmap_tpu.ops.encoding import kmer_hashes, revcomp_hash


# ---------------------------------------------------------------------------
# Canonical k-mer profiles (P7)
# ---------------------------------------------------------------------------

def canonical_kmer_table(k: int) -> tuple[np.ndarray, int]:
    """hash -> dense canonical index. The canonical form of a k-mer is
    itself if hash < revcomp hash else the revcomp (seed_selection/
    utils.py:110-111). Returns (table (4^k,) int32, n_canonical)."""
    h = np.arange(4**k, dtype=np.uint32)
    rc = revcomp_hash(h, k, xp=np)
    canon = np.minimum(h, rc)
    uniq, inv = np.unique(canon, return_inverse=True)
    return inv.astype(np.int32), len(uniq)


def kmer_profile_batch(codes: jnp.ndarray, lengths: jnp.ndarray, k: int,
                       table: jnp.ndarray, n_canonical: int) -> jnp.ndarray:
    """Binary canonical-k-mer presence profiles for a batch of sequences
    (dataset.py:23-33), on device: (B, L) codes -> (B, n_canonical) f32."""
    B, L = codes.shape
    km = kmer_hashes(codes, k, xp=jnp)                       # (B, K)
    pos = jnp.arange(L - k + 1, dtype=jnp.int32)
    valid = pos[None, :] < (lengths[:, None] - (k - 1))
    idx = table[km]
    prof = jnp.zeros((B, n_canonical), jnp.float32)
    return prof.at[jnp.arange(B)[:, None], idx].max(
        jnp.where(valid, 1.0, 0.0))


# ---------------------------------------------------------------------------
# Read dataset (P5's torch Dataset stub, completed)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ReadDataset:
    """Samples (read codes, true bucket) with substitution errors, the
    training stream for the classifier/agent."""

    records: list[FastaRecord]
    cfg: MapperConfig
    substitution_rate: float = 0.02
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._buckets = [(rid, start, codes) for rid, start, codes
                         in iterate_buckets(self.records, self.cfg)]

    @property
    def n_buckets(self) -> int:
        return len(self._buckets)

    def batch(self, n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (codes (n, read_len) uint8, lengths (n,), bucket (n,))."""
        rl = self.cfg.read_len
        codes = np.zeros((n, rl), np.uint8)
        bucket = self._rng.integers(0, self.n_buckets, n)
        for i, b in enumerate(bucket):
            seq = self._buckets[b][2]
            s = int(self._rng.integers(0, max(1, len(seq) - rl)))
            r = seq[s:s + rl].copy()
            err = self._rng.random(len(r)) < self.substitution_rate
            r[err] = (r[err] + self._rng.integers(1, 4, err.sum())) % 4
            codes[i, : len(r)] = r
        return codes, np.full(n, rl, np.int32), bucket.astype(np.int32)


# ---------------------------------------------------------------------------
# MLP bucket classifier (P7)
# ---------------------------------------------------------------------------

class MLPBucketClassifier:
    """profile -> ReLU(Linear(d_model)) -> Linear(n_buckets)
    (seed_selection/dataset.py:111-129), flax/optax."""

    def __init__(self, k: int = 9, d_model: int = 2048, lr: float = 1e-3,
                 seed: int = 0):
        import flax.linen as nn
        import optax

        self.k = k
        table, n_can = canonical_kmer_table(k)
        self.table = jnp.asarray(table)
        self.n_canonical = n_can

        class Net(nn.Module):
            n_out: int
            d: int

            @nn.compact
            def __call__(self, x):
                x = nn.relu(nn.Dense(self.d)(x))
                return nn.Dense(self.n_out)(x)

        self._Net = Net
        self.d_model = d_model
        self._tx = optax.adam(lr)
        self._seed = seed
        self.params = None
        self._opt_state = None
        self._n_out = None

    def init(self, n_buckets: int):
        net = self._Net(n_out=n_buckets, d=self.d_model)
        self.params = net.init(jax.random.PRNGKey(self._seed),
                               jnp.zeros((1, self.n_canonical)))
        self._opt_state = self._tx.init(self.params)
        self._n_out = n_buckets
        self._apply = jax.jit(net.apply)

        @jax.jit
        def train_step(params, opt_state, profiles, labels):
            def loss_fn(p):
                logits = net.apply(p, profiles)
                onehot = jax.nn.one_hot(labels, n_buckets)
                return -jnp.mean(jnp.sum(
                    jax.nn.log_softmax(logits) * onehot, axis=1))

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = self._tx.update(grads, opt_state, params)
            import optax
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        self._train_step = train_step

    def profiles(self, codes: np.ndarray, lengths: np.ndarray) -> jnp.ndarray:
        return kmer_profile_batch(jnp.asarray(codes),
                                  jnp.asarray(lengths, jnp.int32),
                                  self.k, self.table, self.n_canonical)

    def fit(self, dataset: ReadDataset, steps: int = 200,
            batch_size: int = 128, log_every: int = 0) -> list[float]:
        if self.params is None:
            self.init(dataset.n_buckets)
        losses = []
        for t in range(steps):
            codes, lens, labels = dataset.batch(batch_size)
            prof = self.profiles(codes, lens)
            self.params, self._opt_state, loss = self._train_step(
                self.params, self._opt_state, prof, jnp.asarray(labels))
            losses.append(float(loss))
            if log_every and t % log_every == 0:
                print(f"[mlp] step {t} loss {float(loss):.4f}")
        return losses

    def predict(self, codes: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        logits = self._apply(self.params, self.profiles(codes, lengths))
        return np.asarray(jnp.argmax(logits, axis=1))

    def accuracy(self, dataset: ReadDataset, n: int = 512) -> float:
        codes, lens, labels = dataset.batch(n)
        return float((self.predict(codes, lens) == labels).mean())


# ---------------------------------------------------------------------------
# Repetitive-region filter (P7)
# ---------------------------------------------------------------------------

class RepetitiveRegionFilter:
    """Bucket-pairwise Jaccard similarity over canonical k-mer presence
    profiles (seed_selection/filter.py:8-31). The reference loops over
    O(B^2) python pairs; here intersections are ONE (B, G) x (G, B)
    matmul on the MXU and the union follows by inclusion-exclusion."""

    def __init__(self, cfg: MapperConfig, k: int = 9):
        self.cfg = cfg
        self.k = k
        table, n_can = canonical_kmer_table(k)
        self.table = jnp.asarray(table)
        self.n_canonical = n_can

    def read(self, records: list[FastaRecord]) -> jnp.ndarray:
        """Per-bucket profiles, (B, n_canonical) float32."""
        rows = []
        for _rid, _start, codes in iterate_buckets(records, self.cfg):
            c = jnp.asarray(codes[None, :])
            ln = jnp.asarray([len(codes)], jnp.int32)
            rows.append(kmer_profile_batch(c, ln, self.k, self.table,
                                           self.n_canonical)[0])
        return jnp.stack(rows)

    @partial(jax.jit, static_argnums=0)
    def _ji(self, profiles):
        inter = jnp.dot(profiles, profiles.T,
                        preferred_element_type=jnp.float32)
        sizes = profiles.sum(axis=1)
        union = sizes[:, None] + sizes[None, :] - inter
        ji = jnp.where(union > 0, inter / union, 0.0)
        return ji * (1.0 - jnp.eye(ji.shape[0]))   # zero diagonal (ref :27)

    def ji_matrix(self, profiles: jnp.ndarray) -> np.ndarray:
        return np.asarray(self._ji(profiles))


# ---------------------------------------------------------------------------
# RL environment + DQN (P5)
# ---------------------------------------------------------------------------

class ReferenceGenomeEnv:
    """The reference's gym Env (reinforcement_learning.py:9-52) without
    the gym dependency: observation = read codes (read_len,), action =
    bucket id, reward = 1 iff correct, every episode one step."""

    def __init__(self, records: list[FastaRecord], bucket_length: int = 100_000,
                 read_length: int = 100, substitution_rate: float = 0.02,
                 seed: int = 0):
        self.bucket_length = bucket_length
        self.read_length = read_length
        self.substitution_rate = substitution_rate
        self.sequence = np.concatenate([r.codes for r in records])
        self.sequence_length = len(self.sequence)
        self.num_chunks = int(np.ceil(self.sequence_length / bucket_length))
        self.action_space_n = self.num_chunks
        self._rng = np.random.default_rng(seed)
        self.last_observation_bucket: int | None = None

    def _observe(self) -> np.ndarray:
        index = int(self._rng.integers(
            0, self.sequence_length - self.read_length - 1))
        self.last_observation_bucket = index // self.bucket_length
        obs = self.sequence[index:index + self.read_length].copy()
        err = self._rng.random(len(obs)) < self.substitution_rate
        obs[err] = (obs[err] + self._rng.integers(1, 4, err.sum())) % 4
        return obs

    def reset(self) -> np.ndarray:
        return self._observe()

    def step(self, action: int):
        reward = 1 if self.last_observation_bucket == action else 0
        return self._observe(), reward, True, {}


class DQNAgent:
    """Compact DQN over the env: Q(one-hot-mean profile) with an MLP,
    epsilon-greedy, replay buffer, TD(0) targets. Single-step episodes
    make the target just the reward — the env is a contextual bandit,
    which is exactly what the reference's DQN reduces to."""

    def __init__(self, env: ReferenceGenomeEnv, k: int = 6,
                 d_model: int = 512, lr: float = 1e-3, eps: float = 0.1,
                 seed: int = 0):
        import flax.linen as nn
        import optax

        self.env = env
        self.k = k
        table, n_can = canonical_kmer_table(k)
        self.table = jnp.asarray(table)
        self.n_canonical = n_can
        self.eps = eps
        self._rng = np.random.default_rng(seed)

        class QNet(nn.Module):
            n_actions: int
            d: int

            @nn.compact
            def __call__(self, x):
                x = nn.relu(nn.Dense(self.d)(x))
                return nn.Dense(self.n_actions)(x)

        net = QNet(n_actions=env.action_space_n, d=d_model)
        self.params = net.init(jax.random.PRNGKey(seed),
                               jnp.zeros((1, n_can)))
        self._tx = optax.adam(lr)
        self._opt_state = self._tx.init(self.params)
        self._apply = jax.jit(net.apply)

        @jax.jit
        def train_step(params, opt_state, profiles, actions, rewards):
            def loss_fn(p):
                q = net.apply(p, profiles)
                qa = q[jnp.arange(q.shape[0]), actions]
                return jnp.mean((qa - rewards) ** 2)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = self._tx.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        self._train_step = train_step

    def _profile(self, obs: np.ndarray) -> jnp.ndarray:
        return kmer_profile_batch(
            jnp.asarray(obs[None, :]),
            jnp.asarray([len(obs)], jnp.int32),
            self.k, self.table, self.n_canonical)

    def act(self, obs: np.ndarray) -> int:
        if self._rng.random() < self.eps:
            return int(self._rng.integers(0, self.env.action_space_n))
        q = self._apply(self.params, self._profile(obs))
        return int(jnp.argmax(q[0]))

    def learn(self, total_timesteps: int = 500, batch_size: int = 64,
              buffer_size: int = 2048) -> float:
        """Train; returns the final-100-step average reward."""
        buf_prof, buf_act, buf_rew = [], [], []
        rewards = []
        obs = self.env.reset()
        for _ in range(total_timesteps):
            a = self.act(obs)
            prof = np.asarray(self._profile(obs)[0])
            obs, r, _done, _ = self.env.step(a)
            rewards.append(r)
            buf_prof.append(prof)
            buf_act.append(a)
            buf_rew.append(r)
            if len(buf_prof) > buffer_size:
                buf_prof.pop(0), buf_act.pop(0), buf_rew.pop(0)
            if len(buf_prof) >= batch_size:
                sel = self._rng.integers(0, len(buf_prof), batch_size)
                self.params, self._opt_state, _ = self._train_step(
                    self.params, self._opt_state,
                    jnp.asarray(np.stack([buf_prof[i] for i in sel])),
                    jnp.asarray(np.array([buf_act[i] for i in sel])),
                    jnp.asarray(np.array([buf_rew[i] for i in sel],
                                         np.float32)))
        return float(np.mean(rewards[-100:]))
