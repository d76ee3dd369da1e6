"""Observation log-likelihoods (Gaussian / Laplace, precision-parameterised)."""

import math

import torch

_LOG_HALF = math.log(0.5)
_LOG_2PI = math.log(2.0 * math.pi)


def log_prob_gaussian(x_obs, x_predict, precisions):
    return -0.5 * (_LOG_2PI - torch.log(precisions) + precisions * (x_predict - x_obs) ** 2)


def log_prob_laplace(x_obs, x_predict, precisions):
    return _LOG_HALF + torch.log(precisions) - precisions * torch.abs(x_predict - x_obs)


def log_prob_observations(x_predict, x_obs, precisions, use_laplace=False):
    """x_obs[B,S,T] vs x_predict[B,K,S,T] -> log-prob by species [B,K,S]
    (summed over the time axis); ``precisions`` may be a broadcastable view
    such as [B,K,S,1]."""
    lpfunc = log_prob_laplace if use_laplace else log_prob_gaussian
    return torch.sum(lpfunc(x_obs[:, None, :, :], x_predict, precisions), dim=3)
