"""The port's in-process fake of the Video Query API (a copy of
``videoquery/testing``) and its HTTP bridge. Imports nothing eagerly."""
