"""Viewing a saved map: loading params.npz and rendering a view."""
