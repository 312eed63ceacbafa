"""Block placement over the fabric's logical devices (the mesh itself is
ROADMAP item 15)."""
