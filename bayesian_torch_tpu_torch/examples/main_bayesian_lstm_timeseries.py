"""Bayesian LSTM sequence regression with uncertainty, the port's trainer
(counterpart of
``bayesian_torch_tpu/examples/main_bayesian_lstm_timeseries.py``).

    python -m bayesian_torch_tpu_torch.examples.main_bayesian_lstm_timeseries \\
        --steps=200

A Bayesian LSTM and a Bayesian linear head (``BayesianLSTMRegressor``) are
trained on windows of a noisy synthetic signal (or the 1-D array
``series`` of ``--data-npz``) with the Gaussian NLL + KL / batch ELBO and
Adam(``--lr``); the model is saved to
``<save_dir>/lstm_<estimator>.pt``. ``--mode=test`` loads it instead.
Both modes then evaluate ``--num_monte_carlo`` draws (``mc_forward``) on
held-out windows and print the test RMSE of the predictive mean, the
aleatoric and epistemic std and the 2-sigma coverage; ``main`` returns the
RMSE. The loss is printed every 50 steps and at the last step.
``--device`` (default ``cuda``) names where the model runs.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch
from torch import nn

import bayesian_torch_tpu_torch.layers as bayesian_layers
from bayesian_torch_tpu_torch.parallel import mc_forward
from bayesian_torch_tpu_torch.utils.checkpoint import (load_checkpoint,
                                                       save_checkpoint)


def build_parser():
    p = argparse.ArgumentParser(description="Bayesian LSTM time series")
    p.add_argument("--estimator", type=str, default="Reparameterization",
                   choices=["Reparameterization", "Flipout"])
    p.add_argument("--seq-len", type=int, default=64)
    p.add_argument("--hidden", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--steps", type=int, default=500)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--mode", type=str, default="train",
                   choices=["train", "test"])
    p.add_argument("--num_monte_carlo", type=int, default=20)
    p.add_argument("--save_dir", type=str, default="./checkpoint/lstm")
    p.add_argument("--data-npz", type=str, default=None,
                   help="npz with 1-D array 'series'")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device the model runs on")
    return p


def make_series(n=20000, seed=0):
    """Synthetic regime-switching noisy sinusoid."""
    rs = np.random.RandomState(seed)
    t = np.arange(n) * 0.05
    y = (np.sin(t) + 0.5 * np.sin(2.7 * t)
         + 0.15 * rs.randn(n)
         + 0.4 * np.sin(0.11 * t) ** 2)
    return y.astype(np.float32)


def windows(series, seq_len, batch_size, rs):
    starts = rs.randint(0, len(series) - seq_len - 1, size=batch_size)
    x = np.stack([series[s:s + seq_len] for s in starts])[..., None]
    y = np.stack([series[s + 1:s + seq_len + 1] for s in starts])[..., None]
    return x, y


class BayesianLSTMRegressor(nn.Module):
    """LSTM(1 -> H) + Linear(H -> 2): per-step mean and log-variance
    (a heteroscedastic head for the aleatoric uncertainty). Returns
    ``(out, kl)`` with ``out[..., 0]`` the mean and ``out[..., 1]`` the
    log-variance."""

    def __init__(self, hidden, estimator, generator=None, device=None):
        super().__init__()
        lstm = getattr(bayesian_layers, "LSTM" + estimator)
        linear = getattr(bayesian_layers, "Linear" + estimator)
        self.lstm = lstm(1, hidden, generator=generator, device=device)
        self.head = linear(hidden, 2, generator=generator, device=device)

    def forward(self, x):
        h_seq, _, kl1 = self.lstm(x)
        out, kl2 = self.head(h_seq)
        return out, kl1 + kl2


def gaussian_nll(pred, target):
    mean, logvar = pred[..., :1], pred[..., 1:]
    return 0.5 * (torch.exp(-logvar) * (target - mean) ** 2 + logvar).mean()


def train_step(model, optimizer, x, y):
    """One ELBO step: the Gaussian NLL + KL / batch, backward, update.
    Returns the loss (detached)."""
    pred, kl = model(x)
    loss = gaussian_nll(pred, y) + kl / x.shape[0]
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return loss.detach()


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if args.data_npz:
        series = np.load(args.data_npz)["series"].astype(np.float32)
    else:
        series = make_series()
    n_test = len(series) // 5
    train_series, test_series = series[:-n_test], series[-n_test:]

    model = BayesianLSTMRegressor(
        args.hidden, args.estimator,
        generator=torch.Generator().manual_seed(args.seed), device=device)
    ckpt = os.path.join(args.save_dir, f"lstm_{args.estimator.lower()}.pt")

    if args.mode == "train":
        optimizer = torch.optim.Adam(model.parameters(), lr=args.lr)
        rs = np.random.RandomState(args.seed)
        for step in range(args.steps):
            x, y = (torch.from_numpy(a).to(device) for a in windows(
                train_series, args.seq_len, args.batch_size, rs))
            loss = train_step(model, optimizer, x, y)
            if step % 50 == 0 or step == args.steps - 1:
                print(f"step {step}: nll+kl {loss.item():.4f}")
        save_checkpoint(model, ckpt)
    else:
        load_checkpoint(model, ckpt)

    # MC predictive evaluation on held-out windows
    model.eval()
    rs = np.random.RandomState(123)
    x, y = windows(test_series, args.seq_len, args.batch_size, rs)
    preds, _ = mc_forward(model, torch.from_numpy(x).to(device),
                          args.num_monte_carlo)
    preds = preds.float().cpu().numpy()  # (MC, B, T, 2)
    means = preds[..., 0]
    ale = np.exp(preds[..., 1]).mean(0) ** 0.5      # aleatoric std
    epi = means.std(0)                              # epistemic std
    pred_mean = means.mean(0)
    rmse = float(np.sqrt(((pred_mean - y[..., 0]) ** 2).mean()))
    print(f"test RMSE {rmse:.4f} | aleatoric std {ale.mean():.4f} | "
          f"epistemic std {epi.mean():.4f}")
    # calibration: fraction of targets within 2 total-std
    total = np.sqrt(ale ** 2 + epi ** 2)
    cover = float((np.abs(pred_mean - y[..., 0]) < 2 * total).mean())
    print(f"2-sigma coverage {cover * 100:.1f}% (ideal ~95%)")
    return rmse


if __name__ == "__main__":
    main()
