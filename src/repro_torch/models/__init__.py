"""The dense paged decoder and its weight bridge."""
