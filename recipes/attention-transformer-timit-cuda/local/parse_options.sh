# Kaldi-style option parsing for user recipe scripts (role of
# utils/parse_options.sh): turns "--foo-bar value" into $foo_bar and
# supports "--config file" sourcing with command-line priority.
#
# Usage inside a script that pre-declares defaults:
#   stage=0
#   . ./local/parse_options.sh
# Then: ./script.sh --stage 3 --some-opt value positional...

config=

while true; do
  case "$1" in
    --)  # end-of-options terminator
      shift; break
      ;;
    --*)
      if [ $# -lt 2 ]; then
        echo "parse_options.sh: option $1 requires a value" 1>&2
        exit 1
      fi
      name=$(echo "$1" | sed 's/^--//; s/-/_/g')
      if [ "$name" = "config" ]; then
        config="$2"; shift 2
        [ -f "$config" ] && . "$config"
        continue
      fi
      # only accept options that were pre-declared (parse_options contract)
      if ! eval "[ -n \"\${$name+x}\" ]"; then
        echo "parse_options.sh: unknown option --$(echo "$name" | tr _ -)" 1>&2
        exit 1
      fi
      eval "$name=\"\$2\""
      shift 2
      ;;
    *) break ;;
  esac
done
