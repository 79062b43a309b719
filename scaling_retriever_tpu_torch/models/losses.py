"""Ranking losses and sparsity regularizers (port of models/losses.py).

  * regularizers: L1, L0, FLOPS, sparsity ratio, L1 difference, and the
    quadratic ramp of the regularizer weight (``reg_weight_at_step`` as a
    function of the step, ``RegWeightScheduler`` as the stateful form);
  * ranking losses: NCE cross-entropy over in-batch negatives, MarginMSE,
    KL divergence (batchmean, log target), and NCE plus KL.

Softmaxes, the cross-entropy and the KL run in float32 whatever the reps'
dtype, as in the reference. The losses are over the whole global batch
(over several ranks the encoders gather the reps first, as the
reference's one program sees them); ``loss_scale`` in the trainer carries
the reference's ``1/world_size`` factor where a recipe wants it.
"""

from __future__ import annotations

import torch


# ---------------------------------------------------------------------------
# Regularizers
# ---------------------------------------------------------------------------

def l1(batch_rep: torch.Tensor) -> torch.Tensor:
    return batch_rep.abs().sum(dim=-1).mean()


def l0(batch_rep: torch.Tensor) -> torch.Tensor:
    """Average number of non-zeros (no gradient; a statistic)."""
    return (batch_rep != 0).float().sum(dim=-1).mean()


def flops(batch_rep: torch.Tensor) -> torch.Tensor:
    """FLOPS regularizer: sum_j (mean_i |x_ij|)^2."""
    return (batch_rep.abs().mean(dim=0) ** 2).sum()


def sparsity_ratio(batch_rep: torch.Tensor, output_dim: int) -> torch.Tensor:
    return 1.0 - (batch_rep != 0).float().sum(dim=-1).mean() / output_dim


def l1_diff(input_rep: torch.Tensor, target_rep: torch.Tensor
            ) -> torch.Tensor:
    if input_rep.shape != target_rep.shape or input_rep.dim() != 2:
        raise ValueError(f"l1_diff takes two [B, D] reps of one shape, got "
                         f"{tuple(input_rep.shape)} and "
                         f"{tuple(target_rep.shape)}")
    return (input_rep - target_rep).abs().sum(dim=-1).mean()


def init_regularizer(reg: str, **kwargs):
    table = {"L1": l1, "L0": l0, "FLOPS": flops, "L1_diff": l1_diff}
    if reg == "sparsity_ratio":
        dim = kwargs["output_dim"]
        return lambda x: sparsity_ratio(x, dim)
    if reg not in table:
        raise NotImplementedError("provide valid regularizer")
    return table[reg]


def reg_weight_at_step(lambda_: float, T: int, step: int) -> float:
    """The quadratic ramp ``lambda * (min(t, T) / T)^2``, computed in float32
    as the reference computes it."""
    t = torch.minimum(torch.tensor(float(step), dtype=torch.float32),
                      torch.tensor(float(T), dtype=torch.float32))
    return float(lambda_ * (t / float(T)) ** 2)


class RegWeightScheduler:
    """The stateful form of the ramp: ``step()`` advances t by one and
    freezes at T."""

    def __init__(self, lambda_: float, T: int):
        self.lambda_ = lambda_
        self.T = T
        self.t = 0
        self.lambda_t = 0.0

    def step(self) -> float:
        if self.t < self.T:
            self.t += 1
            self.lambda_t = self.lambda_ * (self.t / self.T) ** 2
        return self.lambda_t

    def get_lambda(self) -> float:
        return self.lambda_t


# ---------------------------------------------------------------------------
# Ranking losses
# ---------------------------------------------------------------------------

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy with integer labels, in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0].mean()


def kldiv_batchmean_log_target(student_logp: torch.Tensor,
                               teacher_logp: torch.Tensor) -> torch.Tensor:
    """``KLDivLoss(reduction='batchmean', log_target=True)``:
    sum(exp(t) * (t - s)) / batch size."""
    t, s = teacher_logp.float(), student_logp.float()
    return (t.exp() * (t - s)).sum() / t.shape[0]


def nce_loss(query_reps: torch.Tensor, context_reps: torch.Tensor,
             labels: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    """Contrastive loss over the in-batch negatives."""
    logits = query_reps @ context_reps.T
    return cross_entropy(logits / temperature, labels)


def margin_mse_loss(query_rep: torch.Tensor, pos_rep: torch.Tensor,
                    neg_rep: torch.Tensor, teacher_pos: torch.Tensor,
                    teacher_neg: torch.Tensor,
                    temperature: float = 1.0) -> torch.Tensor:
    """MSE between the student's and the teacher's margins (the dense head
    divides the student's margin by T)."""
    student = ((query_rep * pos_rep).sum(dim=-1)
               - (query_rep * neg_rep).sum(dim=-1))
    teacher = teacher_pos - teacher_neg
    diff = student.float() / temperature - teacher.float()
    return (diff ** 2).mean()


def kldiv_loss(query_rep: torch.Tensor, context_reps: torch.Tensor,
               teacher_scores: torch.Tensor,
               temperature: float = 1.0) -> torch.Tensor:
    """KL distillation over each query's [pos, negs...] group.

    context_reps: [B * (1 + n_negs), D], each query's group contiguous.
    """
    bz, width = teacher_scores.shape
    ctx = context_reps.reshape(bz, width, -1)
    logits = (query_rep[:, None, :] * ctx).sum(dim=-1) / temperature
    s = torch.log_softmax(logits.float(), dim=-1)
    t = torch.log_softmax(teacher_scores.float(), dim=-1)
    return kldiv_batchmean_log_target(s, t)


def nce_kldiv_loss(query_reps: torch.Tensor, context_reps: torch.Tensor,
                   labels: torch.Tensor, teacher_scores: torch.Tensor,
                   teacher_idxes: torch.Tensor, temperature: float = 1.0
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """NCE over the whole in-batch matrix plus KL on the teacher's slots:
    ``teacher_idxes`` maps each query's [pos, negs...] to columns of the
    [n_query, n_context] logits. Returns (rank, nce, kl), rank = (nce +
    kl) / 2."""
    logits = query_reps @ context_reps.T
    nce = cross_entropy(logits / temperature, labels)
    kl_logits = logits.gather(1, teacher_idxes.long())
    s = torch.log_softmax(kl_logits.float() / temperature, dim=-1)
    t = torch.log_softmax(teacher_scores.float(), dim=-1)
    kl = kldiv_batchmean_log_target(s, t)
    return (nce + kl) / 2.0, nce, kl
