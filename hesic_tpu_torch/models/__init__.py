"""HESIC and its fast codec; HESIC+ and its wavefront device codec."""
