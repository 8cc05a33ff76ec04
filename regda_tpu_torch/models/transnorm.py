"""TransNorm: two-domain batch normalization with a channel-importance
residual (counterpart of regda_tpu/models/transnorm.py).

Reference: regda/trans_norm.py:8-430 (`_TransNorm`, `TransNorm1d/2d/3d`,
which the used model configuration does not wire in). The batch is
[source; target] halves (trans_norm.py:169-232): each half is normalized by
its own batch statistics, with a shared affine; a per-channel importance
alpha = C * p / sum(p), p = 1 / (1 + |mu_s / sigma_s - mu_t / sigma_t|),
scales the output by (1 + alpha), alpha without a gradient. Each domain
keeps its running statistics (torch's momentum convention, new = (1 - m)
old + m batch, the unbiased variance); at eval time the target statistics
normalize the whole batch.

Channel-last inputs of any rank, as in the JAX package: (B, C), (B, H, W,
C) or (B, D, H, W, C); the statistics reduce over every axis but the last.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn


class TransNorm(nn.Module):
    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5,
                 affine: bool = True):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features))
            self.bias = nn.Parameter(torch.zeros(num_features))
        else:
            self.register_parameter('weight', None)
            self.register_parameter('bias', None)
        for domain in ('source', 'target'):
            self.register_buffer(f'mean_{domain}', torch.zeros(num_features))
            self.register_buffer(f'var_{domain}', torch.ones(num_features))

    def _standardize(self, v, mu, var):
        z = (v - mu) * torch.rsqrt(var + self.eps)
        if self.weight is not None:
            z = z * self.weight + self.bias
        return z

    def _alpha(self, mu_s, var_s, mu_t, var_t):
        dis = torch.abs(mu_s * torch.rsqrt(var_s + self.eps)
                        - mu_t * torch.rsqrt(var_t + self.eps))
        prob = 1.0 / (1.0 + dis)
        return (prob.shape[-1] * prob / prob.sum()).detach()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        red = tuple(range(x.ndim - 1))
        if not self.training:
            z = self._standardize(x, self.mean_target, self.var_target)
            return z * (1.0 + self._alpha(self.mean_source, self.var_source,
                                          self.mean_target, self.var_target))
        half = x.shape[0] // 2
        xs, xt = x[:half], x[half:]
        mu_s = xs.mean(dim=red)
        va_s = ((xs - mu_s) ** 2).mean(dim=red)
        mu_t = xt.mean(dim=red)
        va_t = ((xt - mu_t) ** 2).mean(dim=red)
        n = max(math.prod(xs.shape[:-1]), 2)
        bessel = n / (n - 1)
        with torch.no_grad():
            m = self.momentum
            for buf, val in ((self.mean_source, mu_s), (self.var_source, va_s * bessel),
                             (self.mean_target, mu_t), (self.var_target, va_t * bessel)):
                buf.mul_(1 - m).add_(m * val)
        z = torch.cat([self._standardize(xs, mu_s, va_s),
                       self._standardize(xt, mu_t, va_t)])
        # alpha from the current batch statistics (unbiased variance)
        return z * (1.0 + self._alpha(mu_s, va_s * bessel, mu_t, va_t * bessel))


# the reference's rank-specific names
TransNorm1d = TransNorm
TransNorm2d = TransNorm
TransNorm3d = TransNorm
