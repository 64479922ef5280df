"""The sentinel-padding contract shared by the port's kernels.

Real base codes are 0..3.  Query pads take ``Q_PAD`` and target pads take
``T_PAD``; the two never compare equal, so a padded cell always takes the
mismatch penalty and can never raise a score (see ``swtpu.ops.common``,
whose values these are).
"""

Q_PAD = 5
T_PAD = 4
