"""Progressive renderer and framebuffer export."""
