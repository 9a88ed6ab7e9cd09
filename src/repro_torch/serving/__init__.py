"""Serving: the engines, the continuous-batching scheduler and the paged
KV pool's host side."""
