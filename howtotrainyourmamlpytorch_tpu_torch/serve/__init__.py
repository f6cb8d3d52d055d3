"""Serving engine and adapted-params cache of the port."""

from .engine import EpisodeRequest, ServeConfig, ServingEngine

__all__ = ["EpisodeRequest", "ServeConfig", "ServingEngine"]
