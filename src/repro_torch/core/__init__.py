# The paper's primary contribution — implement the SYSTEM here
# (scheduler, optimizer, data path, serving loop, etc.) in the
# host framework. Add sibling subpackages for substrates.
