"""Token-reduction methods on the shared backbone."""
