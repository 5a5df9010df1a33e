"""Render-side tables (the cubemap axes)."""
