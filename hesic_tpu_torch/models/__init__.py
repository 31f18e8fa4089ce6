"""HESIC and its fast codec."""
