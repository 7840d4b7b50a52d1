"""Forecasts and the batched MPC solve."""
