"""Algorithm-1 serving core (host side): RaLMSeq/RaLMSpec, caches, OS^3."""
